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
// Bound on the H100: operations, barely. 2 x 20,000 points x 64 boxes are
// 2.6M point-box tests of ~25 operations (sin and cos included), while the
// bytes are < 1 MB; either bound is a few microseconds, so the launch
// dominates. Design: one thread per point loops over the sample's boxes in
// order and stops at the first hit; the boxes are read through the L1
// cache, the same 64 boxes for every thread of a sample.
#include <cuda_runtime.h>

namespace {

__global__ void points_in_boxes_kernel(const float* __restrict__ pts,
                                       const unsigned char* __restrict__ pvalid,
                                       const float* __restrict__ boxes,
                                       const unsigned char* __restrict__ gvalid,
                                       int batch, int n, int g,
                                       unsigned char* __restrict__ label,
                                       float* __restrict__ offsets) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= batch * n) return;
  const int b = q / n;
  const float px = pts[3LL * q], py = pts[3LL * q + 1], pz = pts[3LL * q + 2];
  unsigned char hit = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (pvalid[q]) {
    const float* bb = boxes + 7LL * b * g;
    const unsigned char* gv = gvalid + static_cast<long long>(b) * g;
    for (int j = 0; j < g; ++j) {
      if (!gv[j]) continue;
      const float* bx = bb + 7 * j;
      const float dx = px - bx[0];
      const float dy = py - bx[1];
      const float c = cosf(bx[6]);
      const float s = sinf(bx[6]);
      const float lx = dx * c - dy * s;
      const float ly = dx * s + dy * c;
      const float cz = bx[2] + bx[5] * 0.5f;
      if (fabsf(lx) <= bx[3] * 0.5f && fabsf(ly) <= bx[4] * 0.5f &&
          fabsf(pz - cz) <= bx[5] * 0.5f) {
        hit = 1;
        ox = px - bx[0];
        oy = py - bx[1];
        oz = pz - cz;
        break;
      }
    }
  }
  label[q] = hit;
  offsets[3LL * q] = ox;
  offsets[3LL * q + 1] = oy;
  offsets[3LL * q + 2] = oz;
}

}  // namespace

// pts [batch * n, 3] float32; pvalid [batch * n] bool; boxes [batch, g, 7]
// float32; gvalid [batch, g] bool; label [batch * n] bool; offsets
// [batch * n, 3] float32.
extern "C" int sassd_points_in_boxes(const float* pts,
                                     const unsigned char* pvalid,
                                     const float* boxes,
                                     const unsigned char* gvalid, int batch,
                                     int n, int g, unsigned char* label,
                                     float* offsets, void* stream) {
  const int total = batch * n;
  if (total > 0) {
    const int threads = 256;
    points_in_boxes_kernel<<<(total + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        pts, pvalid, boxes, gvalid, batch, n, g, label, offsets);
  }
  return static_cast<int>(cudaGetLastError());
}
