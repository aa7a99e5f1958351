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
// Design: a block owns a 64 x 64 tile of pairs.
// - Per-box staging: the block's prologue computes each of its 64 a-boxes
//   and 64 b-boxes once (cos, sin, the 4 corners, half dims, area, cull
//   radius) into shared memory, with the same cosf/sinf and operation
//   order as a pair's own computation, so every per-pair value is bitwise
//   what computing it pair by pair gives. sin and cos are taken once per
//   box and tile, not 4 times per pair.
// - An exact separation cull: a pair whose centres lie farther apart than
//   r_a + r_b + kCullMargin (r the circumradius, 0.5 sqrt(w^2 + l^2))
//   cannot touch; every clipped edge is empty, and the pair's value is +0.0
//   in every criterion. The margin (1 cm) is 40 times the float32 spacing
//   at 2,048 m, which bounds every coordinate that the clipping computes for
//   a cullable box (centre and sizes within kCullLimit = 1,000 m, all five
//   fields finite); any other box gets a NaN radius, the comparison is
//   false and the pair takes the full path. riou_kernel.near_pairs_plain is
//   the same test in PyTorch.
// - The full clipping only for the near pairs: each warp ballots its near
//   pairs into a shared list, and the block's threads then work through
//   the list, so a near pair does not hold a warp of culled ones on the
//   full path. Culled pairs store +0.0 as they are found, a warp's 32
//   stores to 32 adjacent floats.
// Bound on the H100: the 4 bytes a pair written (16.1 MB at 2008 x 2008
// boxes, 0.0048 ms at 3.35 TB/s); the cull's ~9 operations a pair and the
// ~400 of each near pair's clipping lie below that wherever the near pairs
// are a few percent.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsShrink = 1e-5f;  // EPS_SHRINK of riou_kernel.py
constexpr float kCullMargin = 1e-2f;  // CULL_MARGIN of riou_kernel.py, m
constexpr float kCullLimit = 1000.0f;  // CULL_LIMIT of riou_kernel.py, m
constexpr int kTile = 64;              // boxes a tile side
constexpr int kThreads = 256;

// One box as the pairs read it: the clipping box's frame (centre, cos,
// sin, half dims), its CCW corners as a subject, its area and cull radius.
// 17 words, odd, so that a warp reading one field of 32 boxes touches 32
// banks of shared memory.
struct RiouStaged {
  float x, y, c, s, hw, hl, area, cull_r;
  float cx[4], cy[4];
  float pad;
};

// The corners of a center-format box with clockwise yaw, and the rest, in
// the operation order of the per-pair code: c and s are the cosf and sinf
// that both its corner and its clipping-frame computations took.
__device__ __forceinline__ RiouStaged riou_stage(const float* p) {
  const float x = p[0], y = p[1], w = p[2], l = p[3], r = p[4];
  RiouStaged out;
  const float c = cosf(r), s = sinf(r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // corner signs (0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5)
    const float lx = (k == 0 || k == 3 ? 0.5f : -0.5f) * w;
    const float ly = (k < 2 ? 0.5f : -0.5f) * l;
    out.cx[k] = lx * c + ly * s + x;
    out.cy[k] = -lx * s + ly * c + y;
  }
  out.x = x;
  out.y = y;
  out.c = c;
  out.s = s;
  out.hw = w * 0.5f;
  out.hl = l * 0.5f;
  out.area = w * l;
  const bool cullable = isfinite(x) && isfinite(y) && isfinite(w) &&
                        isfinite(l) && isfinite(r) && fabsf(x) <= kCullLimit &&
                        fabsf(y) <= kCullLimit && fabsf(w) <= kCullLimit &&
                        fabsf(l) <= kCullLimit;
  out.cull_r = cullable ? 0.5f * sqrtf(w * w + l * l)
                        : __int_as_float(0x7fc00000);  // NaN: never culled
  return out;
}

// 1/d with a sign-preserving floor, so axis-parallel segments give large
// finite slab bounds instead of NaNs.
__device__ __forceinline__ float riou_safe_recip(float d) {
  const float tiny = 1e-12f;
  const float safe = d >= 0.0f ? fmaxf(d, tiny) : fminf(d, -tiny);
  return 1.0f / safe;
}

// Sum of cross(p', q') over the 4 directed edges of `cs`'s corners, each
// clipped to the rectangle `clip` (slab test in its local frame, endpoints
// evaluated in the global frame). subject=true widens a face by EPS when
// the segment runs along the face's CCW direction and narrows it otherwise;
// subject=false narrows every face, so coincident arcs are counted by one
// pass only.
__device__ __forceinline__ float riou_clipped_cross_sum(
    const RiouStaged& cs, const RiouStaged& clip, bool subject) {
  const float eps = kEpsShrink;
  const float cc = clip.c, sn = clip.s;
  const float hw = clip.hw, hl = clip.hl;
  float lx[4], ly[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = cs.cx[k] - clip.x;
    const float dy = cs.cy[k] - clip.y;
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
    const float egx = cs.cx[f] - cs.cx[e];
    const float egy = cs.cy[f] - cs.cy[e];
    const float x0 = cs.cx[e] + t0 * egx;
    const float y0 = cs.cy[e] + t0 * egy;
    const float x1 = cs.cx[e] + t1 * egx;
    const float y1 = cs.cy[e] + t1 * egy;
    acc = acc + (t1 > t0 ? x0 * y1 - x1 * y0 : 0.0f);
  }
  return acc;
}

// criterion: 2 raw intersection area, -1 IoU, 0 inter/area_a, 1 inter/area_b.
__device__ __forceinline__ float riou_overlap(const RiouStaged& a,
                                              const RiouStaged& b,
                                              int criterion) {
  float s = riou_clipped_cross_sum(a, b, true);
  s = s + riou_clipped_cross_sum(b, a, false);
  const float inter = fmaxf(s * 0.5f, 0.0f);
  if (criterion == 2) return inter;
  float denom;
  if (criterion == -1) {
    denom = a.area + b.area - inter;
  } else if (criterion == 0) {
    denom = a.area;
  } else {
    denom = b.area;
  }
  return inter / fmaxf(denom, 1e-7f);
}

__global__ void __launch_bounds__(kThreads)
riou_overlap_kernel(const float* __restrict__ a, int n,
                    const float* __restrict__ b, int m, int criterion,
                    float* __restrict__ out) {
  __shared__ RiouStaged sa[kTile], sb[kTile];
  __shared__ unsigned short near[kTile * kTile];
  __shared__ int n_near;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int t = threadIdx.x;
  if (t < kTile) {
    if (i0 + t < n) sa[t] = riou_stage(a + 5 * (i0 + t));
  } else if (t < 2 * kTile) {
    const int j = j0 + t - kTile;
    if (j < m) sb[t - kTile] = riou_stage(b + 5 * j);
  }
  if (t == 0) n_near = 0;
  __syncthreads();
  // the cull, 4 tile rows a pass: consecutive threads on consecutive j; a
  // thread keeps its b-box in registers, a warp reads one a-box (a
  // broadcast)
  const int lane = t & 31;
  const int jl = t % kTile;
  const float qx = sb[jl].x, qy = sb[jl].y, qr = sb[jl].cull_r;
  for (int il = t / kTile; il < kTile; il += kThreads / kTile) {
    const int i = i0 + il, j = j0 + jl;
    bool keep = false;
    if (i < n && j < m) {
      const RiouStaged& p = sa[il];
      const float dx = p.x - qx;
      const float dy = p.y - qy;
      const float reach = p.cull_r + qr + kCullMargin;
      if (dx * dx + dy * dy > reach * reach) {
        out[static_cast<long long>(i) * m + j] = 0.0f;
      } else {
        keep = true;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (ballot) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&n_near, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep) {
        near[base + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(il * kTile + jl);
      }
    }
  }
  __syncthreads();
  // the full clipping of the near pairs, the block's threads in turn
  const int count = n_near;
  for (int k = t; k < count; k += kThreads) {
    const int il = near[k] / kTile, jl = near[k] % kTile;
    out[static_cast<long long>(i0 + il) * m + (j0 + jl)] =
        riou_overlap(sa[il], sb[jl], criterion);
  }
}

}  // namespace

extern "C" int sassd_riou_overlap(const float* a, int n, const float* b,
                                  int m, int criterion, float* out,
                                  void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    riou_overlap_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        a, n, b, m, criterion, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sassd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
