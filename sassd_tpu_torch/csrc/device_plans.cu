// K6: the device-built rulebook of the sparse backbone: per-level dense
// index maps and the 27-tap gather plans resolved through them.
//
// Replaces: sassd_tpu/ops/sparse.py build_index_map, lookup_dense3,
// _window_plan, build_subm_plan and build_stride_plan (the dense-index,
// windowed path that vxnet_apply takes without host plans).
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

__global__ void window_plan_kernel(const int* __restrict__ out_keys,
                                   int m_out, int oh, int ow, int scale,
                                   const int* __restrict__ map, int d, int h,
                                   int w, int* __restrict__ plan) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;                       // tap group (dz, dy)
  const int b = blockIdx.z;
  if (m >= m_out) return;
  const int key = out_keys[static_cast<long long>(b) * m_out + m];
  int r0 = -1, r1 = -1, r2 = -1;
  if (key != kInvalidKey) {
    const int x = scale * (key % ow);
    const int y = scale * ((key / ow) % oh);
    const int z = scale * (key / (ow * oh));
    const int zq = z + g / 3 - 1;
    const int yq = y + g % 3 - 1;
    if (x >= 0 && x < w && zq >= 0 && zq < d && yq >= 0 && yq < h) {
      const long long total = static_cast<long long>(d) * h * w;
      const int* mb = map + static_cast<long long>(b) * total;
      const long long q = (static_cast<long long>(zq) * h + yq) * w + x;
      if (x >= 1) r0 = mb[q - 1];
      r1 = mb[q];
      if (x + 1 < w) r2 = mb[q + 1];
    }
  }
  int* pb = plan + (static_cast<long long>(b) * 27 + 3 * g) * m_out + m;
  pb[0] = r0;
  pb[m_out] = r1;
  pb[2 * m_out] = r2;
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
