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
// Design: a cudaMemsetAsync and one thread per valid row for the map. The
// plans of a scan (subm0-2, stride1-3: up to six) in one launch, one
// thread a (plan, sample, output row): it decodes its key once, issues its
// 27 map loads together (the 9 tap groups' three x-consecutive cells, read
// directly from the map), then writes its 27 entries, each store coalesced
// along M_out; a padding row writes -1 and reads no map. A block finds its
// plan from a prefix of block counts. That is the TPU version's
// SASSD_WINDOW_TABLE=0 form, identical in result to its window-table form;
// the [total + 1, 3] table (~1 GB at L0) is never built. A plan alone is
// 0.3-2 MB of writes, which as a launch of its own is mostly ramp-up and
// tail (2.2-3.6 us at car b1), hence one launch for the six; a thread a
// tap group of a row instead was no faster at car b1 (PERF.md, row B8).
// Bound on the H100: bytes, the plans' write once (27 x 4 B a row slot,
// 10.3 MB for the six plans at the car caps), the keys and the map cells
// read.
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
// K18, K19 and K20: K6's plans, K13 and K14 resolved with no index map
// (model.plan_lookup="sorted"): each tap group's window of consecutive
// keys is found by a lower-bound search over the input (K19: output)
// level's sorted keys, and the window's keys are compared with the cells.
// Replaces: sassd_tpu/ops/sparse.py lookup_sorted3 with
// _window_plan(sorted_keys=...) through build_subm_plan and
// build_stride_plan (sorted_lookup=True), build_stride_plan_T
// (out_sorted_keys=...) and build_aux_plan (level_sorted_keys=...).
// Same tap order and masks as K6's plans, K13 and K14, in kernels of their
// own. Bound on the H100: bytes, the plans' write (10.3 MB for the six
// plans at the car caps, ~0.0031 ms) and the keys read once (80 KB at the
// car's level-0 cap: the L2 holds every level's). What stands between: a
// row's searches, ~16 dependent steps each at 20,000 keys, and too few of
// them in flight where the rows leave the SMs part empty. Design: a
// thread's searches take the same steps, so they advance together, an
// independent load each a step (lower_bounds, then window); a padding row
// or a group off the grid does no search. The whole capped row is
// searched, INVALID_KEY tail included, as the JAX package does. K18 and
// K20 are one kernel (sorted_plans_kernel): K20's three levels are its
// plans, a row's base cell cell0 >> L, so each level takes blocks of its
// own and the three run side by side. Where a launch's rows x batch are
// fewer than the card's resident threads (the car's caps at batch 1 and
// 2), three threads take a row, a z plane of taps each, so three times the
// chains are in flight; where the rows fill the card (the long-range caps,
// the band rows), the split's extra decode costs more than that, and a
// thread takes the row. K19 (sorted_stride_plans_t_kernel), a thread an
// input row, searches only the row's live tap groups, at most four of
// nine, each a pair of parent slots whose window cell a tap reads at a
// compile-time index (no dynamically indexed registers, no stack).
// Measured on the H100 and not kept: a thread a tap group
// (slower); K19's row split where the card is part idle, once the row
// searched four slots: over two threads, a z parent each, 1-4% faster at
// car b2 by the profiler and no faster replayed, so one form stays; over
// three, a z plane each, up to 5% slower; a splitter table of every S-th
// key in shared memory for the top steps (slower: those are L1 hits
// already, a block's threads visit the same midpoints), with a block's
// key segments staged there for the rest (a step costs as much issued to
// shared memory as to the L1).
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
// fresh map writes the whole grid (360 MB at L0). Design: the three
// levels of a scan in one entry point of two kernels, the clear of every
// level's previous keys, then the set of every level's keys; each kernel
// one grid of a thread a key over the levels' keys concatenated, a block
// finding its level from a prefix of block counts; no memset. A level
// alone is under one block an SM (79, 72 and 56 blocks of 256 on 132 SMs
// at the car caps), hence the shared grid. No grid barrier: the stream
// orders the two kernels.
#include <cuda_runtime.h>

#include <cstdint>

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

// One level of K17's update: its keys (the previous scan's for the
// clear, this scan's for the set), its map and grid size; its blocks
// start at block first of the grid's x.
struct KeyLevel {
  const int* keys;
  int* map;
  long long total;
  int m, first;
};

// K17's levels, passed by value.
struct KeyLevels {
  KeyLevel l[3];
  int n;
};

constexpr int kMapThreads = 256;

// K17's write for this thread's row of level k in block blk, sample b:
// map[b, key] = -1 (kClear) or the row, with index_map_kernel's rules
// (INVALID_KEY, negative keys and keys off the grid are skipped).
template <bool kClear>
__device__ __forceinline__ void update_key(const KeyLevel& k, int blk,
                                           int b) {
  const int row = (blk - k.first) * kMapThreads + threadIdx.x;
  if (row >= k.m) return;
  const int key = k.keys[static_cast<long long>(b) * k.m + row];
  if (key == kInvalidKey || key < 0 || key >= k.total) return;
  k.map[static_cast<long long>(b) * k.total + key] = kClear ? -1 : row;
}

// K17: update_key over every valid key of every level. The level is
// chosen by three branches of constant index (uniform in a block), so
// the parameters are read in place, not copied to a stack frame.
template <bool kClear>
__global__ void __launch_bounds__(kMapThreads)
    index_maps_update_kernel(KeyLevels lv) {
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  if (lv.n > 2 && blk >= lv.l[2].first)
    update_key<kClear>(lv.l[2], blk, b);
  else if (lv.n > 1 && blk >= lv.l[1].first)
    update_key<kClear>(lv.l[1], blk, b);
  else
    update_key<kClear>(lv.l[0], blk, b);
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

// K18-K20's search: the lower bounds p[g] (the first row whose key is >=
// v[g]) of the searches set in `on` over one sample's ascending keys
// kb[0..m), the INVALID_KEY tail included (it sorts last; JAX searches the
// whole capped row too). A search's steps depend only on m, so the
// searches advance together: each step issues up to n independent loads,
// and the dependent chain is ceil(log2 m) + 1 loads deep, not n times that.
// The keys (80 KB at the car's level-0 cap) stay in the L2.
template <int n>
__device__ __forceinline__ void lower_bounds(const int* __restrict__ kb,
                                             int m, const int* v,
                                             unsigned on, int* p) {
#pragma unroll
  for (int g = 0; g < n; ++g) p[g] = 0;
  if (on == 0 || m <= 0) return;
  for (int len = m; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int g = 0; g < n; ++g)
      if (((on >> g) & 1u) && kb[p[g] + half] < v[g]) p[g] += half;
    len -= half;
  }
#pragma unroll
  for (int g = 0; g < n; ++g)
    if (((on >> g) & 1u) && kb[p[g]] < v[g]) ++p[g];
}

// The rows r[0..n) of the keys v, ..., v + n - 1 in kb[p..p+n), p being
// v's lower bound, -1 where absent (lookup_sorted3's window, n = 3: the
// keys are unique, so each present one lies there; the first match wins,
// as its argmax). v + 2 stays below 2^31: the wrappers refuse larger
// grids.
template <int n>
__device__ __forceinline__ void window(const int* __restrict__ kb, int m,
                                       int p, int v, int* r) {
#pragma unroll
  for (int j = 0; j < n; ++j) r[j] = -1;
#pragma unroll
  for (int s = 0; s < n; ++s) {
    if (p + s < m) {
      const int k = kb[p + s];
#pragma unroll
      for (int j = 0; j < n; ++j)
        if (k == v + j && r[j] < 0) r[j] = p + s;
    }
  }
}

// K18's and K20's lookup, window_rows of the n tap groups (9, or 3: one
// z plane) from group 3 gz resolved in one sample's sorted keys kb[0..m)
// instead of its map: per group the window of the three x-consecutive
// cells from (zq, yq, x - 1), searched from its first cell, with
// window_rows's grid and per-tap x masks, into r[3 (g - 3 gz) ..]. A
// group off the grid does no search.
template <int n>
__device__ __forceinline__ void sorted_window_rows(const int* __restrict__ kb,
                                                   int m, int z, int y, int x,
                                                   int d, int h, int w,
                                                   int gz, int* r) {
  int v[n], p[n];
  unsigned on = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const int zq = z + gz + i / 3 - 1;
    const int yq = y + i % 3 - 1;
    v[i] = 0;
    if (z >= 0 && x >= 0 && x < w && zq >= 0 && zq < d && yq >= 0 &&
        yq < h) {
      v[i] = (zq * h + yq) * w + x - 1;
      on |= 1u << i;
    }
  }
  lower_bounds<n>(kb, m, v, on, p);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    int* rg = r + 3 * i;
    rg[0] = rg[1] = rg[2] = -1;
    if ((on >> i) & 1u) {
      window<3>(kb, m, p[i], v[i], rg);
      if (x < 1) rg[0] = -1;
      if (x + 1 >= w) rg[2] = -1;
    }
  }
}

// One plan of K6's window plans: its output keys on the output grid (oh,
// ow), the input level's map on the input grid (d, h, w), the base cell's
// scale and the plan; its blocks start at block first of the grid's x.
struct PlanSpec {
  const int* out_keys;
  const int* in;
  int* plan;
  int m_out, oh, ow, scale, d, h, w, first;
};

constexpr int kMaxPlans = 6;

struct PlanSpecs {
  PlanSpec p[kMaxPlans];
  int n;
};

constexpr int kPlanThreads = 128;

// K6's window plans: a thread resolves one output row of one plan and
// sample. It decodes its key once, issues its 27 map loads, then writes
// them, each store coalesced along M_out.
__global__ void __launch_bounds__(kPlanThreads)
    window_plans_kernel(PlanSpecs ps) {
  const int blk = blockIdx.x;
  int p = 0;
#pragma unroll
  for (int j = 1; j < kMaxPlans; ++j)
    if (j < ps.n && blk >= ps.p[j].first) p = j;
  const PlanSpec& s = ps.p[p];
  const int m = (blk - s.first) * kPlanThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int m_out = s.m_out;
  if (m >= m_out) return;
  const int key = s.out_keys[static_cast<long long>(b) * m_out + m];
  int x = -1, y = -1, z = -1;
  if (key != kInvalidKey) {
    x = s.scale * (key % s.ow);
    y = s.scale * ((key / s.ow) % s.oh);
    z = s.scale * (key / (s.ow * s.oh));
  }
  const int d = s.d, h = s.h, w = s.w;
  int r[27];
  const int* mb = s.in + static_cast<long long>(b) * d * h * w;
#pragma unroll
  for (int g = 0; g < 9; ++g)
    window_rows(mb, z, y, x, g, d, h, w, r + 3 * g);
  int* pb = s.plan + static_cast<long long>(b) * 27 * m_out + m;
#pragma unroll
  for (int k = 0; k < 27; ++k)
    pb[static_cast<long long>(k) * m_out] = r[k];
}

// The three levels' index maps and grids, passed by value.
struct AuxLevels {
  const int* in[3];
  int d[3], h[3], w[3];
};

constexpr int kAuxThreads = 128;

// K14: the window plans of cell0 >> L at the three levels.
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
    int r[27];
    const int* mb = lv.in[l] + static_cast<long long>(b) * d * h * w;
#pragma unroll
    for (int g = 0; g < 9; ++g)
      window_rows(mb, z0 >> (l + 1), y0 >> (l + 1), x0 >> (l + 1), g, d, h,
                  w, r + 3 * g);
    int* pb = plan + (static_cast<long long>(l) * batch + b) * 27 * m0 + m;
#pragma unroll
    for (int k = 0; k < 27; ++k) pb[static_cast<long long>(k) * m0] = r[k];
  }
}

// One plan of K18 or one level of K20, resolved in the input level's m_in
// sorted keys (keys) on the grid (d, h, w). Its rows: K18 output keys on
// the grid (., oh, ow), the base cell scale times the key's cell; K20
// level-0 zyx cells, the base cell each >> cell_shift (-1 on padding).
// Its plan [batch, 27, m_out]; its blocks start at block first of the
// grid's x.
struct SortedPlanSpec {
  const int* out_keys;
  const int* cells;
  const int* keys;
  int* plan;
  int m_out, oh, ow, scale, cell_shift, d, h, w, m_in, first;
};

struct SortedPlanSpecs {
  SortedPlanSpec p[kMaxPlans];
  int n;
};

constexpr int kSortedThreads = 128;

// K18 (kCells false) and K20 (kCells true): a thread resolves kGroups tap
// groups (9: all of a row's; 3: a z plane of taps, blockIdx.z) of one row
// of one plan and sample. It finds its base cell, its groups' searches
// advanced together and their windows (sorted_window_rows), then writes
// their 3 kGroups entries, each store coalesced along m_out.
template <bool kCells, int kGroups>
__global__ void __launch_bounds__(kSortedThreads)
    sorted_plans_kernel(SortedPlanSpecs ps) {
  const int blk = blockIdx.x;
  int p = 0;
#pragma unroll
  for (int j = 1; j < kMaxPlans; ++j)
    if (j < ps.n && blk >= ps.p[j].first) p = j;
  const SortedPlanSpec& s = ps.p[p];
  const int m = (blk - s.first) * kSortedThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int m_out = s.m_out;
  if (m >= m_out) return;
  int x = -1, y = -1, z = -1;
  if constexpr (kCells) {
    const int* c = s.cells + 3 * (static_cast<long long>(b) * m_out + m);
    if (c[0] >= 0) {
      z = c[0] >> s.cell_shift;
      y = c[1] >> s.cell_shift;
      x = c[2] >> s.cell_shift;
    }
  } else {
    const int key = s.out_keys[static_cast<long long>(b) * m_out + m];
    if (key != kInvalidKey) {
      x = s.scale * (key % s.ow);
      y = s.scale * ((key / s.ow) % s.oh);
      z = s.scale * (key / (s.ow * s.oh));
    }
  }
  const int gz = kGroups == 9 ? 0 : blockIdx.z;
  int r[3 * kGroups];
  sorted_window_rows<kGroups>(s.keys + static_cast<long long>(b) * s.m_in,
                              s.m_in, z, y, x, s.d, s.h, s.w, gz, r);
  int* pb = s.plan + (static_cast<long long>(b) * 27 + 9 * gz) * m_out + m;
#pragma unroll
  for (int k = 0; k < 3 * kGroups; ++k)
    pb[static_cast<long long>(k) * m_out] = r[k];
}

// The three levels' input keys, output maps (K19: the output levels'
// m_out sorted keys) and grids, passed by value; level l's blocks start
// at block first[l] of the grid's x.
struct StrideTLevels {
  const int* keys[3];
  const int* map[3];
  int m[3], first[3];
  int d[3], h[3], w[3];
  int od[3], oh[3], ow[3];
  int* out[3];
  int m_out[3];
};

constexpr int kStrideTThreads = 128;

// A 3-bit mask of the live parents (c - off) / 2 of axis coordinate c for
// off = -1, 0, 1: even, non-negative, under n.
__device__ __forceinline__ unsigned parents(int c, int n) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int q = c - (j - 1);
    if (q >= 0 && (q & 1) == 0 && (q >> 1) < n) live |= 1u << j;
  }
  return live;
}

// The same mask, and the parents in p[0..2].
__device__ __forceinline__ unsigned parents(int c, int n, int* p) {
#pragma unroll
  for (int j = 0; j < 3; ++j) p[j] = (c - (j - 1)) >> 1;
  return parents(c, n);
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

// K19: K13's plans resolved in the output levels' sorted keys, a thread
// an input row. Per axis a coordinate c has parent slot 0, (c + 1) >> 1
// (tap j = 1 when c is even, j = 0 when odd), and slot 1, (c - 1) >> 1
// (j = 2, c odd), so tap group (jz, jy) reads slot pair (jz == 2, jy ==
// 2): at most four groups are live, one pair each, and only those four
// pairs are searched. A live pair's x parents lie in the window of output
// cells from sx = floor((x - 1) / 2), searched from that cell: tap jx = 2
// reads its first cell, jx = 0 and 1 its second, so every tap's pair and
// window cell is a compile-time index. Written explicitly: C++'s /
// truncates toward zero, so x = 0 takes sx = -1 by hand, the cell before
// the row, which no live tap reads.
__global__ void __launch_bounds__(kStrideTThreads)
    sorted_stride_plans_t_kernel(StrideTLevels lv) {
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
  int z = 0, y = 0, x = 0;
  if (key >= 0 && static_cast<long long>(key) <
                      static_cast<long long>(d) * h * w) {
    x = key % w;
    y = (key / w) % h;
    z = key / (w * h);
    lz = parents(z, lv.od[l]);
    ly = parents(y, oh);
    lx = parents(x, ow);
  }
  const int sx = x > 0 ? (x - 1) / 2 : -1;
  const int mo = lv.m_out[l];
  const int* kb = lv.map[l] + static_cast<long long>(b) * mo;
  int v[4], p[4];
  unsigned on = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int az = s >> 1, ay = s & 1;
    const bool zon = az ? (lz >> 2) & 1u : (lz & 3u) != 0;
    const bool yon = ay ? (ly >> 2) & 1u : (ly & 3u) != 0;
    v[s] = 0;
    if (lx && zon && yon) {
      v[s] = (((z + 1 - 2 * az) >> 1) * oh + ((y + 1 - 2 * ay) >> 1)) * ow +
             sx;
      on |= 1u << s;
    }
  }
  lower_bounds<4>(kb, mo, v, on, p);
  int r[4][2];  // a slot pair's rows of cells sx and sx + 1
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    r[s][0] = r[s][1] = -1;
    if ((on >> s) & 1u) window<2>(kb, mo, p[s], v[s], r[s]);
  }
  int* pb = lv.out[l] + static_cast<long long>(b) * 27 * m + i;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int jz = k / 9, jy = (k / 3) % 3, jx = k % 3;
    const int s = (jz == 2 ? 2 : 0) + (jy == 2 ? 1 : 0);
    pb[static_cast<long long>(k) * m] =
        (lz >> jz) & (ly >> jy) & (lx >> jx) & 1u ? r[s][jx == 2 ? 0 : 1]
                                                  : -1;
  }
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

// A device pointer passed in an int64 descriptor.
template <typename T>
T* as_ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

// K17. desc: n_levels (1-3) rows of 6 int64, (prev_keys, m_prev, keys, m,
// total, map) of a level: prev_keys [batch, m_prev] and keys [batch, m]
// int32 (INVALID_KEY padded), map [batch, total] int32, the index map of
// prev_keys, updated in place to that of keys. The descriptors are copied
// into the two kernels' parameters; the clears of all levels run before
// the sets.
extern "C" int sassd_index_maps_update(const long long* desc, int n_levels,
                                       int batch, void* stream) {
  if (n_levels < 1 || n_levels > 3 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeyLevels clear = {}, set = {};
  int clear_blocks = 0, set_blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long* d = desc + 6 * l;
    KeyLevel& c = clear.l[l];
    KeyLevel& t = set.l[l];
    c.keys = as_ptr<const int>(d[0]);
    c.m = static_cast<int>(d[1]);
    t.keys = as_ptr<const int>(d[2]);
    t.m = static_cast<int>(d[3]);
    c.total = t.total = d[4];
    c.map = t.map = as_ptr<int>(d[5]);
    c.first = clear_blocks;
    t.first = set_blocks;
    clear_blocks += (c.m + kMapThreads - 1) / kMapThreads;
    set_blocks += (t.m + kMapThreads - 1) / kMapThreads;
  }
  clear.n = set.n = n_levels;
  if (batch > 0 && clear_blocks > 0) {
    index_maps_update_kernel<true>
        <<<dim3(clear_blocks, batch), kMapThreads, 0, s>>>(clear);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0 && set_blocks > 0)
    index_maps_update_kernel<false>
        <<<dim3(set_blocks, batch), kMapThreads, 0, s>>>(set);
  return static_cast<int>(cudaGetLastError());
}

// K6's plans. desc: n_plans (1-6) rows of 10 int64, (out_keys, m_out, oh,
// ow, scale, map, d, h, w, plan) of a plan: out_keys [batch, m_out] int32
// on the output grid (., oh, ow); map [batch, d * h * w] int32 of the
// input grid; plan [batch, 27, m_out] int32. One launch for all.
extern "C" int sassd_window_plans(const long long* desc, int n_plans,
                                  int batch, void* stream) {
  if (n_plans < 1 || n_plans > kMaxPlans || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PlanSpecs ps = {};
  int blocks = 0;
  for (int p = 0; p < n_plans; ++p) {
    const long long* d = desc + 10 * p;
    PlanSpec& sp = ps.p[p];
    sp.out_keys = as_ptr<const int>(d[0]);
    sp.m_out = static_cast<int>(d[1]);
    sp.oh = static_cast<int>(d[2]);
    sp.ow = static_cast<int>(d[3]);
    sp.scale = static_cast<int>(d[4]);
    sp.in = as_ptr<const int>(d[5]);
    sp.d = static_cast<int>(d[6]);
    sp.h = static_cast<int>(d[7]);
    sp.w = static_cast<int>(d[8]);
    sp.plan = as_ptr<int>(d[9]);
    sp.first = blocks;
    blocks += (sp.m_out + kPlanThreads - 1) / kPlanThreads;
  }
  ps.n = n_plans;
  if (batch > 0 && blocks > 0)
    window_plans_kernel<<<dim3(blocks, batch), kPlanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(ps);
  return static_cast<int>(cudaGetLastError());
}

// The threads the current card holds resident at once (0 if unknown).
static long long resident_threads() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                             dev) != cudaSuccess)
    return 0;
  return static_cast<long long>(sms) * per_sm;
}

// K18's and K20's launch of the plans in ps (pointers, sizes and grids
// set): their blocks' offsets, one kernel. A thread a row while the rows
// fill the card's resident threads; below that a thread a row's z plane
// of taps (three a row), which fills more of it (the search chains'
// latency, not their issue, then sets the time).
template <bool kCells>
static int launch_sorted(SortedPlanSpecs& ps, int n, int batch,
                         cudaStream_t stream) {
  if (n < 1 || n > kMaxPlans || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  long long rows = 0;
  for (int p = 0; p < n; ++p) {
    ps.p[p].first = blocks;
    blocks += (ps.p[p].m_out + kSortedThreads - 1) / kSortedThreads;
    rows += ps.p[p].m_out;
  }
  ps.n = n;
  if (batch <= 0 || blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (rows * batch < resident_threads())
    sorted_plans_kernel<kCells, 3>
        <<<dim3(blocks, batch, 3), kSortedThreads, 0, stream>>>(ps);
  else
    sorted_plans_kernel<kCells, 9>
        <<<dim3(blocks, batch, 1), kSortedThreads, 0, stream>>>(ps);
  return static_cast<int>(cudaGetLastError());
}

// K18. desc: n_plans (1-6) rows of 11 int64, (out_keys, m_out, oh, ow,
// scale, in_keys, m_in, d, h, w, plan) of a plan: out_keys [batch, m_out]
// int32 on the output grid (., oh, ow); in_keys [batch, m_in] int32, the
// input level's keys, ascending and unique with an INVALID_KEY tail, on
// the grid (d, h, w) of at most 2^31 - 4 cells; plan [batch, 27, m_out]
// int32. One launch for all.
extern "C" int sassd_sorted_window_plans(const long long* desc, int n_plans,
                                         int batch, void* stream) {
  if (n_plans < 1 || n_plans > kMaxPlans)
    return static_cast<int>(cudaErrorInvalidValue);
  SortedPlanSpecs ps = {};
  for (int p = 0; p < n_plans; ++p) {
    const long long* d = desc + 11 * p;
    SortedPlanSpec& sp = ps.p[p];
    sp.out_keys = as_ptr<const int>(d[0]);
    sp.m_out = static_cast<int>(d[1]);
    sp.oh = static_cast<int>(d[2]);
    sp.ow = static_cast<int>(d[3]);
    sp.scale = static_cast<int>(d[4]);
    sp.keys = as_ptr<const int>(d[5]);
    sp.m_in = static_cast<int>(d[6]);
    sp.d = static_cast<int>(d[7]);
    sp.h = static_cast<int>(d[8]);
    sp.w = static_cast<int>(d[9]);
    sp.plan = as_ptr<int>(d[10]);
  }
  return launch_sorted<false>(ps, n_plans, batch,
                              static_cast<cudaStream_t>(stream));
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

// K19. keys0..2 [batch, mL] int32 input keys of levels 0-2 (INVALID_KEY
// padded) on the grids (dL, hL, wL); out1..3 [batch, mo_L] int32 sorted
// keys of levels 1-3; plan_t1..3 [batch, 27, m_{L-1}] int32.
extern "C" int sassd_sorted_stride_plans_t(
    const int* keys0, const int* keys1, const int* keys2, const int* out1,
    const int* out2, const int* out3, int batch, int m0, int m1, int m2,
    int mo1, int mo2, int mo3, int d0, int h0, int w0, int d1, int h1,
    int w1, int d2, int h2, int w2, int d3, int h3, int w3, int* plan_t1,
    int* plan_t2, int* plan_t3, void* stream) {
  StrideTLevels lv = {{keys0, keys1, keys2}, {out1, out2, out3}, {m0, m1, m2},
                      {0, 0, 0}, {d0, d1, d2}, {h0, h1, h2}, {w0, w1, w2},
                      {d1, d2, d3}, {h1, h2, h3}, {w1, w2, w3},
                      {plan_t1, plan_t2, plan_t3}, {mo1, mo2, mo3}};
  int blocks = 0;
  for (int l = 0; l < 3; ++l) {
    lv.first[l] = blocks;
    blocks += (lv.m[l] + kStrideTThreads - 1) / kStrideTThreads;
  }
  if (batch > 0 && blocks > 0) {
    const dim3 grid(blocks, batch);
    sorted_stride_plans_t_kernel<<<grid, kStrideTThreads, 0,
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

// K20. cell0 [batch, m0, 3] int32 level-0 zyx cells (-1 padding);
// keys1..keys3 [batch, mL] int32 sorted keys of levels 1-3; plan [3,
// batch, 27, m0]. One launch, K18's kernel with the three levels as its
// plans.
extern "C" int sassd_sorted_aux_plans(const int* cell0, int batch, int m0,
                                      const int* keys1, const int* keys2,
                                      const int* keys3, int m1, int m2,
                                      int m3, int d1, int h1, int w1, int d2,
                                      int h2, int w2, int d3, int h3, int w3,
                                      int* plan, void* stream) {
  const int* keys[3] = {keys1, keys2, keys3};
  const int m[3] = {m1, m2, m3};
  const int d[3] = {d1, d2, d3}, h[3] = {h1, h2, h3}, w[3] = {w1, w2, w3};
  SortedPlanSpecs ps = {};
  for (int l = 0; l < 3; ++l) {
    SortedPlanSpec& sp = ps.p[l];
    sp.cells = cell0;
    sp.cell_shift = l + 1;
    sp.keys = keys[l];
    sp.m_out = m0;
    sp.m_in = m[l];
    sp.d = d[l];
    sp.h = h[l];
    sp.w = w[l];
    sp.plan = plan + static_cast<long long>(l) * batch * 27 * m0;
  }
  return launch_sorted<true>(ps, 3, batch,
                             static_cast<cudaStream_t>(stream));
}
