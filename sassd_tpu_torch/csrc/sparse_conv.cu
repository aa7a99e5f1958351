// K4: sparse 3x3x3 convolution as a gather-GEMM over a batched plan.
//
// Replaces: sassd_tpu/ops/sparse.py gather_im2col_triple + _subm_conv_raw
// (the packed im2col gather and the [M, 27*Cin] x [27*Cin, Cout] matmul).
//
// out[b, m] = sum_t sum_c X[b, plan[b, t, m], c] * W[t, c, :], where a
// plan entry of -1 (a missing neighbour) contributes zero. The plan is the
// host rulebook's wire format, [B, 27, M_out] int16 or int32, with rows
// into sample b's segment of the flat [B * M_in, Cin] features; it serves
// submanifold plans (M_in = M_out), stride plans into the previous level
// and the transpose plans of the stride convs' input gradients alike.
//
// Bound on the H100: at the car config only about a fifth of the 27 x
// rows plan slots are found (padding rows past a sample's active count
// find none), so the work is 2 * found * Cin * Cout fp32 operations (L2
// 64 -> 64 at batch 1: ~0.6 GFLOP, 9 us at 67 TFLOP/s) and the bytes of
// the found rows; the smaller convs are bound by the launch and by the
// latency of each tap's gather. The TPU version packed three x-neighbours
// into one wide row because XLA's TPU gather is priced per row; here a
// warp's 16-byte loads of a row are coalesced, so no packing is carried
// over.
//
// Design (output-stationary, no atomics): a block owns 64 output rows of
// one sample and every output channel, with their sums in shared memory.
// It first compacts the tile's plan: its plan entries are loaded all at
// once, then for each tap a warp ballot and prefix count list the found
// rows and their input rows. Taps that find no row are dropped, and a tile
// of padding rows finds nothing and only writes zeros. The remaining taps
// are packed in order into stages of at most 64 rows and 16 KB of weights
// (one tap at 64 -> 64, up to 16 taps at 16 -> 16, so a sparse small tile
// needs 2-3 stages, not 27 round trips). A stage's found input rows and
// its W[t] are copied with 16-byte cp.async into one of two shared-memory
// buffers, so the next stage's copies run under this stage's products.
// Each of 256 threads takes (64 * Cout / 1024) consecutive compacted rows
// of one tap x 4 columns: it loads their sums into registers, continues
// them through the tap's products (a k loop unrolled for Cin 16, 32 and
// 64) and stores them back, tap by tap with a barrier between taps. So the
// FMAs scale with the found slots, not with 27 x rows, and every output
// row is one fma chain over its found taps in the order t = 0..26 and k =
// 0..cin-1: bitwise the sum over all 27 taps with zeros for the missing
// ones (an fma with a zero product leaves the sum as it was). The train
// step's gradients follow the guided anchors' top-k, whose near-ties flip
// with the forward's float32 rounding, so keeping that rounding keeps the
// card's gradients where they were. Shared memory: 88.4 KB at 64 -> 64,
// two blocks an SM.
// What bounds it at 64 -> 64 (measured on the H100 by switching the copies
// or the products off): the products, with one tap's 10-20 rows a stage
// on only 2-3 warps of a block; spreading them over more warps (strided
// rows, a k split over shuffles, 512 threads) lost the register reuse of
// W and measured slower. The products use explicit __fmaf_rn, because the
// library is built with -fmad=false for K1's tie-breaks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // output rows per block
constexpr int kTaps = 27;
constexpr int kMaxCin = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kWeightFloats = 4096;  // W of a stage's taps, per buffer

// dynamic shared memory of a block: the sums, two row buffers, two weight
// buffers and the compacted lists (input row, tile row) of every tap
constexpr int smem_bytes(int cin, int cout) {
  return (kTile * cout + 2 * kTile * cin + 2 * kWeightFloats) * 4 +
         kTaps * kTile * 4 + kTaps * kTile;
}

// CIN > 0: the input width as a constant (the k loop unrolls); 0: cin
template <typename IdxT, int COUT, int CIN>
__global__ void __launch_bounds__(kThreads, 2)
sparse_conv_kernel(const float* __restrict__ feats, int m_in, int cin_arg,
                   const IdxT* __restrict__ plan, int m_out,
                   const float* __restrict__ weight,
                   float* __restrict__ out) {
  const int cin = CIN > 0 ? CIN : cin_arg;
  constexpr int kColThreads = COUT / 4;               // threads across a row
  constexpr int kRowGroups = kThreads / kColThreads;  // 64, 32, 16
  constexpr int kRowsPerThread = kTile / kRowGroups;  // 1, 2, 4
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);       // [kTile][COUT]
  float* xs = acc + kTile * COUT;                      // [2][kTile][cin]
  float* ws = xs + 2 * kTile * cin;                    // [2][kWeightFloats]
  int* lsrc = reinterpret_cast<int*>(ws + 2 * kWeightFloats);  // [27][kTile]
  unsigned char* lrow =
      reinterpret_cast<unsigned char*>(lsrc + kTaps * kTile);
  __shared__ int cnt[kTaps];
  __shared__ int taps[kTaps];         // the taps that find a row, in order
  __shared__ int seg[kTaps];          // their first row in their stage
  __shared__ int first[kTaps + 1];    // stage s takes taps[first[s]..)
  __shared__ int n_stages;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* fb = feats + static_cast<long long>(b) * m_in * cin;
  const IdxT* pb = plan + static_cast<long long>(b) * kTaps * m_out;

  // compaction: warp w lists the found rows of taps w, w + 8, ... (its
  // plan entries are loaded first, all at once)
  constexpr int kWarpTaps = (kTaps + kThreads / 32 - 1) / (kThreads / 32);
  int src[kWarpTaps][kTile / 32];
#pragma unroll
  for (int k = 0; k < kWarpTaps; ++k) {
    const int t = (tid >> 5) + k * (kThreads / 32);
#pragma unroll
    for (int h = 0; h < kTile / 32; ++h) {
      const int m = m0 + h * 32 + lane;
      src[k][h] = t < kTaps && m < m_out
          ? static_cast<int>(pb[static_cast<long long>(t) * m_out + m]) : -1;
    }
  }
#pragma unroll
  for (int k = 0; k < kWarpTaps; ++k) {
    const int t = (tid >> 5) + k * (kThreads / 32);
    if (t >= kTaps) break;
    int base = 0;
#pragma unroll
    for (int h = 0; h < kTile / 32; ++h) {
      const unsigned found = __ballot_sync(0xffffffffu, src[k][h] >= 0);
      if (src[k][h] >= 0) {
        const int at = base + __popc(found & ((1u << lane) - 1u));
        lsrc[t * kTile + at] = src[k][h];
        lrow[t * kTile + at] = static_cast<unsigned char>(h * 32 + lane);
      }
      base += __popc(found);
    }
    if (lane == 0) cnt[t] = base;
  }
  for (int i = tid; i < kTile * COUT / 4; i += kThreads) {
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  // stages: consecutive found taps whose rows (each tap's rounded up to a
  // thread's rows) fill at most one 64-row buffer and whose weights fit
  // one weight buffer
  if (tid == 0) {
    const int per_stage = kWeightFloats / (cin * COUT);
    int n = 0, ns = 0, rows = kTile, in_stage = 0;
    for (int t = 0; t < kTaps; ++t) {
      if (cnt[t] == 0) continue;
      const int padded = (cnt[t] + kRowsPerThread - 1) / kRowsPerThread *
                         kRowsPerThread;
      if (rows + padded > kTile || in_stage == per_stage) {
        first[ns++] = n;
        rows = 0;
        in_stage = 0;
      }
      ++in_stage;
      taps[n] = t;
      seg[n++] = rows;
      rows += padded;
    }
    first[ns] = n;
    n_stages = ns;
  }
  __syncthreads();
  const int ns = n_stages;
  const int c4 = cin >> 2;

  // stage s's found rows and its taps' weights into buffers s & 1
  auto stage = [&](int s) {
    float* xd = xs + (s & 1) * kTile * cin;
    float* wd = ws + (s & 1) * kWeightFloats;
    for (int j = first[s]; j < first[s + 1]; ++j) {
      const int n = cnt[taps[j]];
      const int* ls = lsrc + taps[j] * kTile;
      float* xj = xd + seg[j] * cin;
      for (int i = tid; i < n * c4; i += kThreads) {
        const int r = i / c4;
        const int q = i - r * c4;
        cp_async16(xj + r * cin + 4 * q,
                   fb + static_cast<long long>(ls[r]) * cin + 4 * q);
      }
      const float* wt = weight + static_cast<long long>(taps[j]) * cin * COUT;
      float* wj = wd + (j - first[s]) * cin * COUT;
      for (int i = tid; i < cin * COUT / 4; i += kThreads) {
        cp_async16(wj + 4 * i, wt + 4 * i);
      }
    }
    cp_async_commit();
  };

  const int cg = tid % kColThreads;
  const int rg = tid / kColThreads;
  if (ns > 0) stage(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a thread takes consecutive rows of one tap of the stage (each tap's
    // rows are padded to a multiple of kRowsPerThread), or none
    const int row0 = rg * kRowsPerThread;
    int mine = -1;
    for (int j = first[s]; j < first[s + 1]; ++j) {
      if (seg[j] <= row0) mine = j;
    }
    int t = 0, local = 0, n = 0;
    if (mine >= 0) {
      t = taps[mine];
      local = row0 - seg[mine];
      n = cnt[t];
    }
    // the taps of the stage in order, a barrier between them: a thread
    // continues its rows' sums through its tap's products, so every output
    // row is one fma chain over its found taps in the order t = 0..26 and
    // k = 0..cin-1 (the rows of one tap are distinct)
    const unsigned char* lr = lrow + t * kTile + local;
    for (int j = first[s]; j < first[s + 1]; ++j) {
      if (j > first[s]) __syncthreads();
      if (j != mine || local >= n) continue;
      float p[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 v = local + i < n
            ? *reinterpret_cast<const float4*>(acc + lr[i] * COUT + 4 * cg)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        p[i][0] = v.x;
        p[i][1] = v.y;
        p[i][2] = v.z;
        p[i][3] = v.w;
      }
      const float* xb = xs + (s & 1) * kTile * cin + row0 * cin;
      const float4* wb = reinterpret_cast<const float4*>(
          ws + (s & 1) * kWeightFloats + (mine - first[s]) * cin * COUT) + cg;
#pragma unroll
      for (int k = 0; k < (CIN > 0 ? CIN : kMaxCin); k += 4) {
        if (CIN == 0 && k >= cin) break;
        float4 a[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          a[i] = *reinterpret_cast<const float4*>(xb + i * cin + k);
        }
        float w[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = wb[(k + kk) * (COUT / 4)];
          w[kk][0] = v.x;
          w[kk][1] = v.y;
          w[kk][2] = v.z;
          w[kk][3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              p[i][c] = __fmaf_rn(av[kk], w[kk][c], p[i][c]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (local + i < n) {
          *reinterpret_cast<float4*>(acc + lr[i] * COUT + 4 * cg) =
              make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        }
      }
    }
    __syncthreads();
  }
  const int rows = min(kTile, m_out - m0);
  float4* ob = reinterpret_cast<float4*>(
      out + (static_cast<long long>(b) * m_out + m0) * COUT);
  for (int i = tid; i < rows * COUT / 4; i += kThreads) ob[i] = smem4[i];
}

// raise a kernel's dynamic shared memory limit once per device
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

template <typename IdxT, int COUT, int CIN>
int launch_cin(const float* feats, int m_in, int cin, const IdxT* plan,
               int batch, int m_out, const float* weight, float* out,
               cudaStream_t s) {
  static bool done[64] = {};
  auto kernel = sparse_conv_kernel<IdxT, COUT, CIN>;
  const int err = allow_smem(kernel, smem_bytes(kMaxCin, COUT), done);
  if (err != 0) return err;
  const dim3 grid((m_out + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, smem_bytes(cin, COUT), s>>>(feats, m_in, cin, plan,
                                                       m_out, weight, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdxT, int COUT>
int launch_cout(const float* feats, int m_in, int cin, const IdxT* plan,
                int batch, int m_out, const float* weight, float* out,
                cudaStream_t s) {
  switch (cin) {
    case 16:
      return launch_cin<IdxT, COUT, 16>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    case 32:
      return launch_cin<IdxT, COUT, 32>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    case 64:
      return launch_cin<IdxT, COUT, 64>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    default:
      return launch_cin<IdxT, COUT, 0>(feats, m_in, cin, plan, batch, m_out,
                                       weight, out, s);
  }
}

template <typename IdxT>
int launch(const float* feats, int m_in, int cin, const IdxT* plan,
           int batch, int m_out, const float* weight, int cout, float* out,
           cudaStream_t s) {
  switch (cout) {
    case 16:
      return launch_cout<IdxT, 16>(feats, m_in, cin, plan, batch, m_out,
                                   weight, out, s);
    case 32:
      return launch_cout<IdxT, 32>(feats, m_in, cin, plan, batch, m_out,
                                   weight, out, s);
    case 64:
      return launch_cout<IdxT, 64>(feats, m_in, cin, plan, batch, m_out,
                                   weight, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// feats [batch * m_in, cin] float32 and weight [27, cin, cout] float32,
// both 16-byte aligned (cp.async), cin % 4 == 0, cin <= 64; plan [batch,
// 27, m_out] int16 (plan_is_i16 != 0) or int32; cout in {16, 32, 64};
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
