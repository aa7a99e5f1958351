// K4: sparse 3x3x3 convolution as a gather-GEMM over a batched plan.
//
// Replaces: sassd_tpu/ops/sparse.py gather_im2col_triple + _subm_conv_raw
// (the packed im2col gather and the [M, 27*Cin] x [27*Cin, Cout] matmul).
//
// out[b, m] = sum_t sum_c X[b, plan[b, t, m], c] * W[t, c, :], where a
// plan entry of -1 (a missing neighbour) contributes zero. The plan is the
// host rulebook's wire format, [B, 27, M_out] int16 or int32, with rows
// into sample b's segment of the flat [B * M_in, Cin] features; it serves
// submanifold plans (M_in = M_out) and stride plans into the previous level
// alike.
//
// Bound on the H100: at the car config the convs are small (L0: 20000 rows
// x 27 taps x 16 x 16, 0.28 GFLOP), so the cost is the gathered bytes and
// the launch, not the FLOPs. The TPU version packed three x-neighbours into
// one wide row because XLA's TPU gather is priced per row; here a warp's
// 16-byte loads of a row are coalesced, so no packing is carried over.
// Design: a block owns 64 output rows of one sample and every output
// channel. For each tap it stages W[t] and the 64 gathered input rows (zeros
// where missing) in shared memory, then each of 256 threads accumulates a
// 4-row x (Cout/16)-column micro-tile in float32 registers. The
// [M, 27*Cin] im2col matrix never exists in device memory. The products use
// explicit __fmaf_rn, because the library is built with -fmad=false for
// K1's tie-breaks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = 16 * kRowsPerThread;    // output rows per block
constexpr int kMaxCin = 64;

template <typename IdxT, int COUT>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const float* __restrict__ feats, int m_in, int cin,
                   const IdxT* __restrict__ plan, int m_out,
                   const float* __restrict__ weight,
                   float* __restrict__ out) {
  constexpr int kCols = COUT / 16;                 // columns per thread
  __shared__ float xs[kTileRows][kMaxCin + 1];     // +1: no bank conflicts
  __shared__ float ws[kMaxCin][COUT];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTileRows;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* fb = feats + static_cast<long long>(b) * m_in * cin;
  const IdxT* pb = plan + static_cast<long long>(b) * 27 * m_out;
  const int c4 = cin / 4;

  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < 27; ++t) {
    const float* wt = weight + static_cast<long long>(t) * cin * COUT;
    for (int i = threadIdx.x; i < cin * COUT; i += kThreads) {
      ws[i / COUT][i % COUT] = wt[i];
    }
    const IdxT* pt = pb + static_cast<long long>(t) * m_out;
    for (int i = threadIdx.x; i < kTileRows * c4; i += kThreads) {
      const int r = i / c4;
      const int q = i - r * c4;
      const int m = m0 + r;
      const int src = m < m_out ? static_cast<int>(pt[m]) : -1;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src >= 0) {
        v = reinterpret_cast<const float4*>(
            fb + static_cast<long long>(src) * cin)[q];
      }
      xs[r][4 * q + 0] = v.x;
      xs[r][4 * q + 1] = v.y;
      xs[r][4 * q + 2] = v.z;
      xs[r][4 * q + 3] = v.w;
    }
    __syncthreads();
    for (int k = 0; k < cin; ++k) {
      float a[kRowsPerThread];
      float w[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = __fmaf_rn(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= m_out) continue;
    float* orow = out + (static_cast<long long>(b) * m_out + m) * COUT;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j];
  }
}

template <typename IdxT>
int launch(const float* feats, int m_in, int cin, const IdxT* plan,
           int batch, int m_out, const float* weight, int cout, float* out,
           cudaStream_t s) {
  const dim3 grid((m_out + kTileRows - 1) / kTileRows, batch);
  switch (cout) {
    case 16:
      sparse_conv_kernel<IdxT, 16><<<grid, kThreads, 0, s>>>(
          feats, m_in, cin, plan, m_out, weight, out);
      break;
    case 32:
      sparse_conv_kernel<IdxT, 32><<<grid, kThreads, 0, s>>>(
          feats, m_in, cin, plan, m_out, weight, out);
      break;
    case 64:
      sparse_conv_kernel<IdxT, 64><<<grid, kThreads, 0, s>>>(
          feats, m_in, cin, plan, m_out, weight, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [batch * m_in, cin] float32 (16-byte aligned, cin % 4 == 0,
// cin <= 64); plan [batch, 27, m_out] int16 (plan_is_i16 != 0) or int32;
// weight [27, cin, cout] float32, cout in {16, 32, 64};
// out [batch * m_out, cout] float32.
extern "C" int sassd_sparse_conv(const float* feats, int m_in, int cin,
                                 const void* plan, int plan_is_i16,
                                 int batch, int m_out, const float* weight,
                                 int cout, float* out, void* stream) {
  if (cin <= 0 || cin > kMaxCin || cin % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || m_out == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_is_i16) {
    return launch(feats, m_in, cin, static_cast<const short*>(plan), batch,
                  m_out, weight, cout, out, s);
  }
  return launch(feats, m_in, cin, static_cast<const int*>(plan), batch,
                m_out, weight, cout, out, s);
}
