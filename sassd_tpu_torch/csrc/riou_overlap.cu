// K1: pairwise rotated overlap [N,5] x [M,5] -> [N,M] float32, the
// rotated-rectangle intersection area by Green's theorem.
//
// Replaces: sassd_tpu/ops/pallas/riou_kernel.py rotate_overlap_green (the
// fused-XLA kernel that took the place of the repo's Pallas versions) and
// its helpers _corners, _safe_recip, _edges_clipped_cross_sum. The float32
// operation sequence is the same as there, step by step: the corners, the
// slab test in the clipping box's local frame with a 1e-12 reciprocal
// floor, the direction-aware EPS_SHRINK tie-break for the subject edges,
// max(s/2, 0) and the 1e-7 floor on the criterion denominators.
//
// Numerics: build WITHOUT --use_fast_math. The degenerate pairs (identical,
// edge-touching, collinear, 180-degree flipped boxes) are resolved by the
// +-1e-5 face shifts, and the approximate __sinf/__cosf/reciprocal lose
// more than that. The library is also built with -fmad=false so that the
// products are rounded as in the plain PyTorch version.
//
// Bound on the H100: arithmetic. A pair costs 8 sincos and ~300 float ops
// and reads 40 bytes that stay in L1, against 4 bytes written, so the
// kernel is far from the 3.35 TB/s memory roof; at NMS sizes (N = M = 2000,
// 4M pairs) it is a few tens of microseconds of issue.
// Design: one thread per (i, j) pair, consecutive threads on consecutive j
// so the stores coalesce; no shared memory, since each box is a 20-byte
// read that the L1 serves. Correct first: the per-pair sincos recomputation
// and the full matrix (NMS reads only one triangle) are left for later.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsShrink = 1e-5f;  // EPS_SHRINK of riou_kernel.py

struct RiouBox {
  float x, y, w, l, r;
};

struct RiouCorners {
  float x[4], y[4];
};

__device__ __forceinline__ RiouBox riou_load(const float* p) {
  return RiouBox{p[0], p[1], p[2], p[3], p[4]};
}

// CCW corners of a center-format box with clockwise yaw.
__device__ __forceinline__ RiouCorners riou_corners(const RiouBox& b) {
  const float c = cosf(b.r), s = sinf(b.r);
  const float sx[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float sy[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  RiouCorners out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = sx[k] * b.w;
    const float ly = sy[k] * b.l;
    out.x[k] = lx * c + ly * s + b.x;
    out.y[k] = -lx * s + ly * c + b.y;
  }
  return out;
}

// 1/d with a sign-preserving floor, so axis-parallel segments give large
// finite slab bounds instead of NaNs.
__device__ __forceinline__ float riou_safe_recip(float d) {
  const float tiny = 1e-12f;
  const float safe = d >= 0.0f ? fmaxf(d, tiny) : fminf(d, -tiny);
  return 1.0f / safe;
}

// Sum of cross(p', q') over the 4 directed edges of `cs`, each clipped to
// the rectangle `clip` (slab test in its local frame, endpoints evaluated in
// the global frame). subject=true widens a face by EPS when the segment runs
// along the face's CCW direction and narrows it otherwise; subject=false
// narrows every face, so coincident arcs are counted by one pass only.
__device__ __forceinline__ float riou_clipped_cross_sum(
    const RiouCorners& cs, const RiouBox& clip, bool subject) {
  const float eps = kEpsShrink;
  const float cc = cosf(clip.r), sn = sinf(clip.r);
  const float hw = clip.w * 0.5f, hl = clip.l * 0.5f;
  float lx[4], ly[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = cs.x[k] - clip.x;
    const float dy = cs.y[k] - clip.y;
    lx[k] = dx * cc - dy * sn;
    ly[k] = dx * sn + dy * cc;
  }
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float dlx = lx[f] - lx[e];
    const float dly = ly[f] - ly[e];
    float x_hi, x_lo, y_hi, y_lo;
    if (subject) {
      x_hi = hw + (dly > 0.0f ? eps : -eps);
      x_lo = -hw - (dly < 0.0f ? eps : -eps);
      y_hi = hl + (dlx < 0.0f ? eps : -eps);
      y_lo = -hl - (dlx > 0.0f ? eps : -eps);
    } else {
      x_hi = hw - eps;
      x_lo = -hw + eps;
      y_hi = hl - eps;
      y_lo = -hl + eps;
    }
    const float rdx = riou_safe_recip(dlx);
    const float rdy = riou_safe_recip(dly);
    const float tx1 = (x_lo - lx[e]) * rdx;
    const float tx2 = (x_hi - lx[e]) * rdx;
    const float ty1 = (y_lo - ly[e]) * rdy;
    const float ty2 = (y_hi - ly[e]) * rdy;
    const float t0 = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), 0.0f);
    const float t1 = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), 1.0f);
    const float egx = cs.x[f] - cs.x[e];
    const float egy = cs.y[f] - cs.y[e];
    const float x0 = cs.x[e] + t0 * egx;
    const float y0 = cs.y[e] + t0 * egy;
    const float x1 = cs.x[e] + t1 * egx;
    const float y1 = cs.y[e] + t1 * egy;
    acc = acc + (t1 > t0 ? x0 * y1 - x1 * y0 : 0.0f);
  }
  return acc;
}

// criterion: 2 raw intersection area, -1 IoU, 0 inter/area_a, 1 inter/area_b.
__device__ __forceinline__ float riou_overlap(const RiouBox& a,
                                              const RiouBox& b,
                                              int criterion) {
  float s = riou_clipped_cross_sum(riou_corners(a), b, true);
  s = s + riou_clipped_cross_sum(riou_corners(b), a, false);
  const float inter = fmaxf(s * 0.5f, 0.0f);
  if (criterion == 2) return inter;
  float denom;
  if (criterion == -1) {
    denom = a.w * a.l + b.w * b.l - inter;
  } else if (criterion == 0) {
    denom = a.w * a.l;
  } else {
    denom = b.w * b.l;
  }
  return inter / fmaxf(denom, 1e-7f);
}

__global__ void riou_overlap_kernel(const float* __restrict__ a, int n,
                                    const float* __restrict__ b, int m,
                                    int criterion, float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * m) return;
  const int i = static_cast<int>(idx / m);
  const int j = static_cast<int>(idx % m);
  out[idx] = riou_overlap(riou_load(a + 5 * i), riou_load(b + 5 * j),
                          criterion);
}

}  // namespace

extern "C" int sassd_riou_overlap(const float* a, int n, const float* b,
                                  int m, int criterion, float* out,
                                  void* stream) {
  const long long total = static_cast<long long>(n) * m;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    riou_overlap_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        a, n, b, m, criterion, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sassd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
