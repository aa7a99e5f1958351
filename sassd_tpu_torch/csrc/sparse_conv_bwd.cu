// K10: weight gradient of the sparse 3x3x3 convolution over a batched plan.
//
// Replaces: the dW half of sassd_tpu/ops/sparse.py _subm_conv_sym_bwd (B10)
// and _stride_hostT_bwd (B11): dW = col^T . d_out, where col is the
// [M, 27*Cin] im2col gather of the forward (gather_im2col_triple).
//
// dW[t, ci, co] = sum_g X[b, plan[b, t, m], ci] * d_out[g, co] over the flat
// output rows g = b * m_out + m whose tap t was found (plan >= 0). The plan
// is the host rulebook's wire format, [B, 27, M_out] int16 or int32, with
// rows into sample b's segment of the flat [B * M_in, Cin] features, the
// same plan the forward (K4) ran on: a submanifold plan or a stride plan.
//
// Bound on the H100: operations. At the car config's L2 (2 x 14336 rows,
// 64 -> 64) the products are 2 * found taps * Cin * Cout, ~2 GFLOP of fp32
// FMA, while the bytes (X and d_out read once, 7.3 MB) take ~2 us. The TPU
// version materialised the im2col and ran one MXU matmul; the [M, 27*Cin]
// matrix never exists here. Design: one block per (chunk of chunk_rows
// output rows, tap). It stages 32 gathered input rows (zeros where missing) and
// the 32 matching d_out rows in shared memory and each of 256 threads
// accumulates its Cin*Cout/256 outputs in registers. Partials go to a
// [chunks, 27, Cin, Cout] scratch and a second pass sums them over chunks
// in a fixed order: no atomics, so dW is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;            // rows staged per step
constexpr int kMaxC = 64;
constexpr int kMaxPerThread = kMaxC * kMaxC / kThreads;   // 16

template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_kernel(const float* __restrict__ feats, int m_in, int cin,
                      const IdxT* __restrict__ plan, int batch, int m_out,
                      const float* __restrict__ d_out, int cout,
                      int chunk_rows, float* __restrict__ partial) {
  __shared__ float xs[kTile][kMaxC + 1];
  __shared__ float ds[kTile][kMaxC + 1];
  __shared__ int src[kTile];
  const int chunk = blockIdx.x;
  const int t = blockIdx.y;
  const int total = batch * m_out;
  const int g0 = chunk * chunk_rows;
  const int g1 = min(g0 + chunk_rows, total);
  const int n_out = cin * cout;
  const int per = (n_out + kThreads - 1) / kThreads;
  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.0f;

  const int c4 = cin / 4;
  const int o4 = cout / 4;
  for (int r0 = g0; r0 < g1; r0 += kTile) {
    if (threadIdx.x < kTile) {
      const int g = r0 + threadIdx.x;
      int s = -1;
      if (g < g1) {
        const int b = g / m_out;
        const int m = g - b * m_out;
        const int p = static_cast<int>(
            plan[(static_cast<long long>(b) * 27 + t) * m_out + m]);
        if (p >= 0) s = b * m_in + p;
      }
      src[threadIdx.x] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * c4; i += kThreads) {
      const int r = i / c4;
      const int q = i - r * c4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src[r] >= 0) {
        v = reinterpret_cast<const float4*>(
            feats + static_cast<long long>(src[r]) * cin)[q];
      }
      xs[r][4 * q + 0] = v.x;
      xs[r][4 * q + 1] = v.y;
      xs[r][4 * q + 2] = v.z;
      xs[r][4 * q + 3] = v.w;
    }
    for (int i = threadIdx.x; i < kTile * o4; i += kThreads) {
      const int r = i / o4;
      const int q = i - r * o4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src[r] >= 0) {
        v = reinterpret_cast<const float4*>(
            d_out + static_cast<long long>(r0 + r) * cout)[q];
      }
      ds[r][4 * q + 0] = v.x;
      ds[r][4 * q + 1] = v.y;
      ds[r][4 * q + 2] = v.z;
      ds[r][4 * q + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j >= per) break;
      const int e = threadIdx.x + j * kThreads;
      if (e >= n_out) break;
      const int ci = e / cout;
      const int co = e - ci * cout;
      float a = acc[j];
      for (int r = 0; r < kTile; ++r) {
        a = __fmaf_rn(xs[r][ci], ds[r][co], a);
      }
      acc[j] = a;
    }
    __syncthreads();
  }
  float* out = partial +
      (static_cast<long long>(chunk) * 27 + t) * n_out;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    if (j >= per) break;
    const int e = threadIdx.x + j * kThreads;
    if (e < n_out) out[e] = acc[j];
  }
}

// dw[e] = sum over chunks of partial[chunk, e], in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  int chunks, int n, float* __restrict__ dw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<long long>(c) * n + e];
  dw[e] = s;
}

}  // namespace

// feats [batch * m_in, cin] float32 (16-byte aligned); plan [batch, 27,
// m_out] int16 (plan_is_i16 != 0) or int32; d_out [batch * m_out, cout]
// float32 (16-byte aligned); cin and cout multiples of 4 up to 64;
// chunk_rows a multiple of 32; partial [ceil(batch * m_out / chunk_rows),
// 27, cin, cout] float32 scratch; dw [27, cin, cout].
extern "C" int sassd_sparse_conv_dw(const float* feats, int m_in, int cin,
                                    const void* plan, int plan_is_i16,
                                    int batch, int m_out, const float* d_out,
                                    int cout, int chunk_rows, float* partial,
                                    float* dw, void* stream) {
  if (cin <= 0 || cin > kMaxC || cin % 4 || cout <= 0 || cout > kMaxC ||
      cout % 4 || chunk_rows <= 0 || chunk_rows % kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 27 * cin * cout;
  const long long rows = static_cast<long long>(batch) * m_out;
  if (rows == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * n, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  const dim3 grid(chunks, 27);
  if (plan_is_i16) {
    sparse_conv_dw_kernel<short><<<grid, kThreads, 0, s>>>(
        feats, m_in, cin, static_cast<const short*>(plan), batch, m_out,
        d_out, cout, chunk_rows, partial);
  } else {
    sparse_conv_dw_kernel<int><<<grid, kThreads, 0, s>>>(
        feats, m_in, cin, static_cast<const int*>(plan), batch, m_out, d_out,
        cout, chunk_rows, partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_chunks_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, chunks, n, dw);
  return static_cast<int>(cudaGetLastError());
}
