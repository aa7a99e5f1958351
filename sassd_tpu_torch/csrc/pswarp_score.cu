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
// it) needs no NHWC copy.
//
// K3b replaces the autodiff transpose of the same JAX functions: with g =
// d_score / K for a valid box (0 otherwise), lane k recomputes its point's
// 4 taps and weights, adds g * weight into d_map at every in-range tap
// (atomicAdd: boxes overlap), and takes the chain rule through tx, ty (the
// derivative of floor is 0, as in JAX) and the lattice to (x, y, w, l,
// yaw); a shuffle reduction sums the 28 lanes into d_boxes[:, [0,1,3,4,6]]
// (z and h get 0). Bound: the 7.9 MB d_map it must write (zeroed by the
// caller) at the car config, ~2.4 us; the atomics touch < 2 MB.
#include <cuda_runtime.h>

namespace {

// torch.linspace(-0.5, 0.5, steps)[idx], evaluated as PyTorch does: from
// the start in the first half, from the end in the second.
__device__ __forceinline__ float lin_half(int idx, int steps) {
  if (steps == 1) return -0.5f;
  const float step = 1.0f / static_cast<float>(steps - 1);
  return idx < steps / 2 ? -0.5f + step * static_cast<float>(idx)
                         : 0.5f - step * static_cast<float>(steps - idx - 1);
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

__global__ void pswarp_score_bwd_kernel(
    const float* __restrict__ x, long long sb, long long sk, long long sh,
    long long sw, int h, int w, int k_parts,
    const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
    const float* __restrict__ d_score, int total, int n_per_batch, int wx,
    int wy, float off_x, float off_y, float scale,
    float* __restrict__ d_map, float* __restrict__ d_boxes) {
  const int lane = threadIdx.x & 31;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (g >= total) return;                       // warp-uniform
  const int b = g / n_per_batch;
  const float* bx = boxes + 7LL * g;
  const float go = valid[g] ? d_score[g] / static_cast<float>(k_parts) : 0.0f;
  float dv[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // x, y, w, l, yaw
  if (lane < k_parts && go != 0.0f) {
    const float linx = lin_half(lane / wy, wx);
    const float liny = lin_half(lane % wy, wy);
    const float lx = linx * bx[3];
    const float ly = liny * bx[4];
    const float c = cosf(bx[6]), s = sinf(bx[6]);
    float gx = lx * c + ly * s + bx[0];
    float gy = ly * c - lx * s + bx[1];
    gx = (gx + off_x) * scale;
    gy = (gy + off_y) * scale;
    const float x0f = floorf(gx), y0f = floorf(gy);
    const float tx = gx - x0f, ty = gy - y0f;
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const float* img = x + sb * b + sk * lane;
    float* dimg = d_map + ((static_cast<long long>(b) * k_parts + lane) * h) * w;
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dy = t >> 1, dx = t & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      const bool ok = xi >= 0 && xi < w && yi >= 0 && yi < h;
      const float wgt = (dx ? tx : 1.0f - tx) * (dy ? ty : 1.0f - ty);
      v[t] = ok ? img[sh * yi + sw * xi] : 0.0f;
      if (ok) atomicAdd(dimg + static_cast<long long>(yi) * w + xi, go * wgt);
    }
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
// [batch, k_parts, h, w] (contiguous, zeroed by the caller) and d_boxes
// [batch, n_per_batch, 7].
extern "C" int sassd_pswarp_score_bwd(
    const float* x, long long sb, long long sk, long long sh, long long sw,
    int h, int w, int k_parts, const float* boxes, const unsigned char* valid,
    const float* d_score, int batch, int n_per_batch, int wx, int wy,
    float off_x, float off_y, float scale, float* d_map, float* d_boxes,
    void* stream) {
  const int total = batch * n_per_batch;
  if (total > 0) {
    const int threads = 128;                    // 4 boxes per block
    const int blocks = (total * 32 + threads - 1) / threads;
    pswarp_score_bwd_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, sb, sk, sh, sw, h, w, k_parts, boxes, valid, d_score, total,
        n_per_batch, wx, wy, off_x, off_y, scale, d_map, d_boxes);
  }
  return static_cast<int>(cudaGetLastError());
}
