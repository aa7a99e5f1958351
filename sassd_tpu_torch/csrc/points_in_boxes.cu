// K12: aux-branch point targets: which GT box holds each point, and the
// point's offset from that box's centre.
//
// Replaces: sassd_tpu/core/boxes.py points_in_boxes3d (B14) with the
// masking of sassd_tpu/models/detector.py aux_loss.targets_one.
//
// For point n of sample b (xyz, valid) and the valid GT boxes j of the
// sample in order: (dx, dy) = p.xy - box.xy, lx = dx*cos(r) - dy*sin(r),
// ly = dx*sin(r) + dy*cos(r), and the point is inside when |lx| <= w/2,
// |ly| <= l/2 and |p.z - (z + h/2)| <= h/2. The first box that holds a
// valid point wins: label 1, offset p - (x, y, z + h/2); otherwise label 0
// and offset 0. cosf/sinf (not the fast intrinsics) and -fmad=false keep
// every value bitwise equal to the plain version's torch operations.
//
// Bound on the H100: bytes (< 1 MB at 2 x 20,000 points), a fraction of a
// microsecond; the point-box tests are ~15 operations each. Design: a
// block covers points of one sample (grid: point blocks x samples). It
// stages the sample's valid boxes into shared memory, compacted in slot
// order by a warp ballot and a scan of the warps' counts: each box once,
// by one thread, as (x, y, z + h/2, cos r) and (sin r, w/2, l/2, h/2), the
// same float operations the per-pair test made. Each thread then walks
// only the staged boxes and stops at the first hit, so no sin or cos is
// evaluated per pair and no invalid slot is visited.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    points_in_boxes_kernel(const float* __restrict__ pts,
                           const unsigned char* __restrict__ pvalid,
                           const float* __restrict__ boxes,
                           const unsigned char* __restrict__ gvalid, int n,
                           int g, unsigned char* __restrict__ label,
                           float* __restrict__ offsets) {
  extern __shared__ float4 s_box[];        // [2 * g], compacted valid boxes
  __shared__ int s_warp[kThreads / 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* bb = boxes + 7LL * b * g;
  const unsigned char* gv = gvalid + static_cast<long long>(b) * g;
  int count = 0;                           // boxes staged so far
  for (int base = 0; base < g; base += kThreads) {
    const int j = base + threadIdx.x;
    const bool v = j < g && gv[j];
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = count;
    for (int i = 0; i < kThreads / 32; ++i) {
      if (i < warp) before += s_warp[i];
      total += s_warp[i];
    }
    if (v) {
      const int k = before + __popc(ballot & ((1u << lane) - 1u));
      const float* bx = bb + 7 * j;
      s_box[2 * k] = make_float4(bx[0], bx[1], bx[2] + bx[5] * 0.5f,
                                 cosf(bx[6]));
      s_box[2 * k + 1] = make_float4(sinf(bx[6]), bx[3] * 0.5f,
                                     bx[4] * 0.5f, bx[5] * 0.5f);
    }
    count = total;
    __syncthreads();
  }
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const long long p = static_cast<long long>(b) * n + q;
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  unsigned char hit = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (pvalid[p]) {
    for (int k = 0; k < count; ++k) {
      const float4 a = s_box[2 * k];       // x, y, cz, cos r
      const float4 e = s_box[2 * k + 1];   // sin r, w/2, l/2, h/2
      const float dx = px - a.x;
      const float dy = py - a.y;
      const float lx = dx * a.w - dy * e.x;
      const float ly = dx * e.x + dy * a.w;
      const float dz = pz - a.z;
      if (fabsf(lx) <= e.y && fabsf(ly) <= e.z && fabsf(dz) <= e.w) {
        hit = 1;
        ox = dx;
        oy = dy;
        oz = dz;
        break;
      }
    }
  }
  label[p] = hit;
  offsets[3 * p] = ox;
  offsets[3 * p + 1] = oy;
  offsets[3 * p + 2] = oz;
}

}  // namespace

// pts [batch * n, 3] float32; pvalid [batch * n] bool; boxes [batch, g, 7]
// float32; gvalid [batch, g] bool; label [batch * n] bool; offsets
// [batch * n, 3] float32. g * 32 bytes of dynamic shared memory a block
// (the wrapper keeps g within the default 48 KB).
extern "C" int sassd_points_in_boxes(const float* pts,
                                     const unsigned char* pvalid,
                                     const float* boxes,
                                     const unsigned char* gvalid, int batch,
                                     int n, int g, unsigned char* label,
                                     float* offsets, void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, batch);
    points_in_boxes_kernel<<<grid, kThreads, sizeof(float4) * 2 * g,
                             static_cast<cudaStream_t>(stream)>>>(
        pts, pvalid, boxes, gvalid, n, g, label, offsets);
  }
  return static_cast<int>(cudaGetLastError());
}
