// K3: PSWarp box scores from the part-sensitive map; K3b: their backward.
//
// Replaces: sassd_tpu/ops/warp.py gen_sample_grid +
// bilinear_sample_per_part_packed, and the mean/valid mask of
// sassd_tpu/models/pswarp.py pswarp_apply.
//
// For box g in batch b: a wx x wy lattice (local-x-major, linspace(-0.5,
// 0.5) times w and l), rotated by the clockwise yaw, shifted by
// grid_offsets and scaled to pixels. Part k is sampled bilinearly from
// channel k at lattice point k (zero padding, align_corners semantics) and
// the score is the mean over the K parts, or 0 for an invalid box.
//
// Bound on the H100: latency of dependent gathers. A box reads 4 corners x
// K parts of scattered 4-byte words (448 bytes at K = 28) and writes 4
// bytes; 4096 boxes touch < 2 MB, far below the memory roof, so the cost is
// the gather latency and the launch. The TPU version packed the 2x2
// neighbourhood into one wide row because XLA's TPU gather cost is per row;
// here a warp's 32 lanes issue their loads together instead. Design: one
// warp per box, lane k builds lattice point k and reads its 4 taps with
// per-tap bounds masks; a shuffle reduction gives the mean. The map is read
// through explicit element strides, so the NCHW conv output (or any view of
// it) needs no NHWC copy. On the H100 a CUDA-graph replay of this kernel
// alone, at 2 x 2048 and at 1 x 2048 boxes, reads within 1.3x of a replay
// of a one-element fill, so the design stays; its calls' time is the
// host path (see ops/warp.py).
//
// K3b replaces the autodiff transpose of the same JAX functions: with go =
// d_score / K for a valid box (0 otherwise), the map gradient gets go * w_t
// at each in-range tap t of each part's lattice point, and the chain rule
// through tx, ty (the derivative of floor is 0, as in JAX) and the lattice
// gives d_boxes[:, [0,1,3,4,6]] (z and h get 0). Bound: the 7.9 MB d_map it
// must write at the car config (batch 2), ~2.4 us; under 7.3% of its cells
// get a tap. Design: two passes in one entry point, no memset, no atomics,
// every d_map cell written once and summed in one fixed order, so two calls
// give the same bits:
// - pass A, one warp per box: lane 0 computes the yaw's cos and sin and
//   the warp shares them; lane k builds lattice point k, loads its 4 taps
//   together, reduces d_boxes with shuffles, and writes one tap record per
//   (b, k, box): x0, y0 and go * w_t for t = 0..3 (2 * dy + dx, the plain
//   version's products), or y0 = kNoTaps for an invalid box. Records are
//   [B, K, N], so pass B reads a channel's records coalesced (2 x 28 x 640
//   x 24 B = 860 KB at the car train shape).
// - pass B, one block per (b, k, tile of `rows` rows by `cols` columns):
//   chunks of the channel's records (8 a thread, loaded together) are
//   compacted in box order (ballots, popcounts, a shuffle scan of the
//   warps' counts) into shared memory, keeping those with a tap in the
//   tile. Each thread owns one column of the tile in shared memory; a lane
//   marks the kept records on its column, 32 at a time, and adds their
//   taps in box order. Taps off the map are dropped. The tile, zeros
//   included, is then written out once, coalesced. Tiles narrower than the
//   map shorten each block's serial walk over its kept records, which set
//   pass B's time.
// Recomputing the records in the pass-B blocks instead (no record buffer,
// one launch) was slower on the H100: each block then evaluates sinf and
// cosf for every box of its channel.
#include <cuda_runtime.h>

namespace {

// torch.linspace(-0.5, 0.5, steps)[idx], evaluated as PyTorch does: from
// the start in the first half, from the end in the second, each a fused
// multiply-add (PyTorch's CPU and CUDA kernels round start + step * i once;
// at steps = 7, idx = 3 that gives -1.49e-8 where a separate product and
// sum give 0, and a lattice point on a pixel edge then takes other taps).
__device__ __forceinline__ float lin_half(int idx, int steps) {
  if (steps == 1) return -0.5f;
  const float step = 1.0f / static_cast<float>(steps - 1);
  return idx < steps / 2
             ? __fmaf_rn(step, static_cast<float>(idx), -0.5f)
             : __fmaf_rn(-step, static_cast<float>(steps - idx - 1), 0.5f);
}

__global__ void pswarp_score_kernel(
    const float* __restrict__ x, long long sb, long long sk, long long sh,
    long long sw, int h, int w, int k_parts,
    const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
    int total, int n_per_batch, int wx, int wy, float off_x, float off_y,
    float scale, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (g >= total) return;                       // warp-uniform
  const int b = g / n_per_batch;
  const float* bx = boxes + 7LL * g;
  float v = 0.0f;
  if (lane < k_parts) {
    const float lx = lin_half(lane / wy, wx) * bx[3];
    const float ly = lin_half(lane % wy, wy) * bx[4];
    const float c = cosf(bx[6]), s = sinf(bx[6]);
    float gx = lx * c + ly * s + bx[0];
    float gy = ly * c - lx * s + bx[1];
    gx = (gx + off_x) * scale;
    gy = (gy + off_y) * scale;
    const float x0f = floorf(gx), y0f = floorf(gy);
    const float tx = gx - x0f, ty = gy - y0f;
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const float* img = x + sb * b + sk * lane;
    float taps[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dy = t >> 1, dx = t & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      const bool ok = xi >= 0 && xi < w && yi >= 0 && yi < h;
      const float wgt = (dx ? tx : 1.0f - tx) * (dy ? ty : 1.0f - ty);
      taps[t] = (ok ? img[sh * yi + sw * xi] : 0.0f) * wgt;
    }
    v = taps[0] + taps[1] + taps[2] + taps[3];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) {
    out[g] = valid[g] ? v / static_cast<float>(k_parts) : 0.0f;
  }
}

// y0 of a tap record that carries no taps (an invalid box)
constexpr int kNoTaps = -2147483647 - 1;
// pass B: records a thread loads a chunk (kSlots * cols / 32 <= 32 counts,
// so cols <= 128); an x0 whose two columns lie off every tile
constexpr int kSlots = 8;
constexpr int kMaxCols = 128;
constexpr int kNoColumn = -2;

// Pass A, one warp per box g: d_boxes[g] and the box's tap records.
__global__ void pswarp_score_bwd_records_kernel(
    const float* __restrict__ x, long long sb, long long sk, long long sh,
    long long sw, int h, int w, int k_parts,
    const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
    const float* __restrict__ d_score, int total, int n_per_batch, int wx,
    int wy, float off_x, float off_y, float scale,
    float4* __restrict__ rec_w, int2* __restrict__ rec_xy,
    float* __restrict__ d_boxes) {
  const int lane = threadIdx.x & 31;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (g >= total) return;                       // warp-uniform
  const int b = g / n_per_batch;
  const float* bx = boxes + 7LL * g;
  const float go = valid[g] ? d_score[g] / static_cast<float>(k_parts) : 0.0f;
  float c = 0.0f, s = 0.0f;
  if (lane == 0) {
    c = cosf(bx[6]);
    s = sinf(bx[6]);
  }
  c = __shfl_sync(0xffffffffu, c, 0);
  s = __shfl_sync(0xffffffffu, s, 0);
  float dv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // x, y, w, l, yaw
  if (lane < k_parts) {
    const long long rec =
        (static_cast<long long>(b) * k_parts + lane) * n_per_batch +
        (g - static_cast<long long>(b) * n_per_batch);
    if (go != 0.0f) {
      const float linx = lin_half(lane / wy, wx);
      const float liny = lin_half(lane % wy, wy);
      const float lx = linx * bx[3];
      const float ly = liny * bx[4];
      float gx = lx * c + ly * s + bx[0];
      float gy = ly * c - lx * s + bx[1];
      gx = (gx + off_x) * scale;
      gy = (gy + off_y) * scale;
      const float x0f = floorf(gx), y0f = floorf(gy);
      const float tx = gx - x0f, ty = gy - y0f;
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      const float* img = x + sb * b + sk * lane;
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {               // all 4 loads issued first
        const int yi = y0 + (t >> 1), xi = x0 + (t & 1);
        const bool ok = xi >= 0 && xi < w && yi >= 0 && yi < h;
        v[t] = ok ? img[sh * yi + sw * xi] : 0.0f;
      }
      rec_xy[rec] = make_int2(x0, y0);
      rec_w[rec] = make_float4(go * ((1.0f - tx) * (1.0f - ty)),
                               go * (tx * (1.0f - ty)),
                               go * ((1.0f - tx) * ty), go * (tx * ty));
      // d(sample)/d(tx), d(sample)/d(ty); taps t = 2 * dy + dx
      const float dtx = (1.0f - ty) * (v[1] - v[0]) + ty * (v[3] - v[2]);
      const float dty = (1.0f - tx) * (v[2] - v[0]) + tx * (v[3] - v[1]);
      const float dgx = go * dtx * scale;       // d loss / d metric lattice x
      const float dgy = go * dty * scale;
      dv[0] = dgx;
      dv[1] = dgy;
      dv[2] = dgx * linx * c - dgy * linx * s;
      dv[3] = dgx * liny * s + dgy * liny * c;
      dv[4] = dgx * (ly * c - lx * s) - dgy * (ly * s + lx * c);
    } else {
      rec_xy[rec] = make_int2(0, kNoTaps);
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dv[i] += __shfl_down_sync(0xffffffffu, dv[i], off);
    }
  }
  if (lane == 0) {
    float* db = d_boxes + 7LL * g;
    db[0] = dv[0];
    db[1] = dv[1];
    db[2] = 0.0f;
    db[3] = dv[2];
    db[4] = dv[3];
    db[5] = 0.0f;
    db[6] = dv[4];
  }
}

// Pass B: block (band, column tile, b * K + k) writes rows [r0, r0 +
// n_rows) and columns [c0, c0 + n_cols) of d_map[b, k], thread t owning
// column c0 + t. A chunk is kSlots records a thread, all loaded before any
// is used; slot s of thread t holds record base + s * blockDim.x + t, so the
// (slot, warp, lane) order is box order. Dynamic shared memory: the kept
// records' taps (float4), x0 and y0 for one chunk, then the [rows, cols]
// tile.
__global__ void pswarp_score_bwd_map_kernel(
    const float4* __restrict__ rec_w, const int2* __restrict__ rec_xy,
    int n_per_batch, int h, int w, int rows, int cols,
    float* __restrict__ d_map) {
  extern __shared__ float4 smem[];
  __shared__ int slot_count[kSlots * 32];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int chunk = kSlots * nt;
  float4* kept_w = smem;
  int* kept_x = reinterpret_cast<int*>(kept_w + chunk);
  int* kept_y = kept_x + chunk;
  float* tile = reinterpret_cast<float*>(kept_y + chunk);
  const int r0 = blockIdx.x * rows, c0 = blockIdx.y * cols;
  const int n_rows = min(rows, h - r0), n_cols = min(cols, w - c0);
  const long long channel = blockIdx.z;       // b * K + k
  const bool owner = tid < n_cols;
  if (owner) {
    for (int r = 0; r < n_rows; ++r) tile[r * cols + tid] = 0.0f;
  }
  const int2* xy = rec_xy + channel * n_per_batch;
  const float4* taps = rec_w + channel * n_per_batch;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = 0; base < n_per_batch; base += chunk) {
    int2 p[kSlots];
    float4 q[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {            // every load issued first
      const int i = base + s * nt + tid;
      p[s] = make_int2(0, kNoTaps);
      q[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n_per_batch) {
        p[s] = xy[i];
        q[s] = taps[i];
      }
    }
    unsigned mask[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      // a tap row in [r0, r0 + n_rows) and a tap column in [c0, c0 + n_cols)
      const bool keep = p[s].y >= r0 - 1 && p[s].y < r0 + n_rows &&
                        p[s].x >= c0 - 1 && p[s].x < c0 + n_cols;
      mask[s] = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) slot_count[s * n_warps + warp] = __popc(mask[s]);
    }
    __syncthreads();
    // each warp scans the kSlots * n_warps (<= 32) counts with shuffles
    const int n_counts = kSlots * n_warps;
    const int cnt = lane < n_counts ? slot_count[lane] : 0;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int n_kept = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int before =
          __shfl_sync(0xffffffffu, incl - cnt, s * n_warps + warp);
      if (mask[s] >> lane & 1u) {
        const int pos = before + __popc(mask[s] & lanes_below);
        kept_w[pos] = q[s];
        kept_x[pos] = p[s].x - c0;                // tile-local from here on
        kept_y[pos] = p[s].y - r0;
      }
    }
    __syncthreads();
    // each warp walks the kept records 32 at a time; a lane marks those on
    // its own column, then adds their taps in box order while the warp's
    // other lanes add theirs
    const int lo = warp * 32 - 1, hi = warp * 32 + 31;   // x0 on the warp
    for (int j0 = 0; j0 < n_kept; j0 += 32) {
      const int x0 = j0 + lane < n_kept ? kept_x[j0 + lane] : kNoColumn;
      unsigned ours = __ballot_sync(0xffffffffu, x0 >= lo && x0 <= hi);
      unsigned mine = 0u;
      while (ours) {
        const int src = __ffs(ours) - 1;
        ours &= ours - 1u;
        const int dx = tid - __shfl_sync(0xffffffffu, x0, src);
        if (owner && (dx == 0 || dx == 1)) mine |= 1u << src;
      }
      while (mine) {
        const int j = j0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const float4 t4 = kept_w[j];
        const int dx = tid - kept_x[j];
        const int ra = kept_y[j];                 // the row of taps dy = 0
        if (ra >= 0) tile[ra * cols + tid] += dx ? t4.y : t4.x;
        if (ra + 1 < n_rows) tile[(ra + 1) * cols + tid] += dx ? t4.w : t4.z;
      }
    }
    __syncthreads();                               // before the next chunk
  }
  if (owner) {
    float* out = d_map + (channel * h + r0) * w + c0 + tid;
    for (int r = 0; r < n_rows; ++r) {
      out[static_cast<long long>(r) * w] = tile[r * cols + tid];
    }
  }
}

}  // namespace

extern "C" int sassd_pswarp_score(const float* x, long long sb, long long sk,
                                  long long sh, long long sw, int h, int w,
                                  int k_parts, const float* boxes,
                                  const unsigned char* valid, int batch,
                                  int n_per_batch, int wx, int wy,
                                  float off_x, float off_y, float scale,
                                  float* out, void* stream) {
  const int total = batch * n_per_batch;
  if (total > 0) {
    const int threads = 128;                    // 4 boxes per block
    const int blocks = (total * 32 + threads - 1) / threads;
    pswarp_score_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, sb, sk, sh, sw, h, w, k_parts, boxes, valid, total, n_per_batch,
        wx, wy, off_x, off_y, scale, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// As sassd_pswarp_score, plus d_score [batch, n_per_batch]; writes d_map
// [batch, k_parts, h, w] (contiguous, every element) and d_boxes [batch,
// n_per_batch, 7]. `records` is scratch of batch * k_parts * n_per_batch *
// 24 bytes (16-byte aligned); pass B runs tiles of `rows` rows by `cols`
// columns (cols <= 128, rows * cols <= 5120: with 8 x 128 kept records,
// its shared memory stays under 48 KB).
extern "C" int sassd_pswarp_score_bwd(
    const float* x, long long sb, long long sk, long long sh, long long sw,
    int h, int w, int k_parts, const float* boxes, const unsigned char* valid,
    const float* d_score, int batch, int n_per_batch, int wx, int wy,
    float off_x, float off_y, float scale, int rows, int cols,
    void* records, float* d_map, float* d_boxes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = batch * n_per_batch;
  const long long n_rec = static_cast<long long>(total) * k_parts;
  float4* rec_w = static_cast<float4*>(records);
  int2* rec_xy = reinterpret_cast<int2*>(rec_w + n_rec);
  if (total > 0) {
    const int threads = 128;                    // 4 boxes per block
    const int blocks = (total * 32 + threads - 1) / threads;
    pswarp_score_bwd_records_kernel<<<blocks, threads, 0, st>>>(
        x, sb, sk, sh, sw, h, w, k_parts, boxes, valid, d_score, total,
        n_per_batch, wx, wy, off_x, off_y, scale, rec_w, rec_xy, d_boxes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (cols < 1 || cols > kMaxCols || rows < 1 || rows * cols > 5120) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && k_parts > 0 && h > 0 && w > 0) {
    const int threads = (cols + 31) / 32 * 32;
    const dim3 grid((h + rows - 1) / rows, (w + cols - 1) / cols,
                    batch * k_parts);
    const size_t smem = kSlots * threads * (sizeof(float4) + 2 * sizeof(int)) +
                        static_cast<size_t>(rows) * cols * sizeof(float);
    pswarp_score_bwd_map_kernel<<<grid, threads, smem, st>>>(
        rec_w, rec_xy, n_per_batch, h, w, rows, cols, d_map);
  }
  return static_cast<int>(cudaGetLastError());
}
