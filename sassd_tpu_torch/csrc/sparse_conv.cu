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

// K4-bf16: the same gather-GEMM with bfloat16 operands on the tensor cores
// (model.compute_dtype="bfloat16").
//
// Replaces: sassd_tpu/ops/sparse.py _subm_conv_raw + gather_im2col_triple
// with compute_dtype=bfloat16 (and the input-gradient products of
// _subm_conv_sym_bwd / _stride_hostT_bwd): the gathered rows and W rounded
// to bfloat16 (to nearest even), jnp.dot(..., preferred_element_type=
// float32). out[b, m] = sum_t sum_c bf16(X[b, plan[b, t, m], c]) *
// bf16(W[t, c, :]); every product is exact in float32, the sums are
// float32 (in the tensor cores' order, not K4's one fma chain a row).
//
// Bound on the H100: the found slots' 2 * found * Cin * Cout operations at
// 989 TFLOP/s (dense bf16) take well under a microsecond at every car
// shape, so the bytes bound it (the inputs and the plan read once, the
// output written once), and below that the latency of each stage's row
// gathers.
//
// Design (output-stationary, no atomics, 8 warps): a block owns 64 output
// rows of one sample and every output channel. It loads the tile's 27 x 64
// plan entries into shared memory and marks, for each 16-row group, the
// taps that find a row there (a warp ballot per 32 rows). The taps found in
// the tile, in order t = 0..26, are the K dimension (tap-major, Cin
// columns each); stages of up to 256 columns (4 taps at Cin 64, all 27 at
// Cin 4, padded with zeros to a multiple of 16) are staged into shared
// memory as bfloat16: each found row converted with __float2bfloat16_rn
// as it is copied (zeros where a tap is missing; no cast pass over the
// features) and W[t] transposed to [Cout][K] so that each B fragment is
// one 32-bit load. Warp w takes rows 16 (w % 4) .. + 15 and half of the
// output columns, holds its sums in registers (mma.sync.m16n8k16 bf16 ->
// f32 fragments) and skips every k step whose taps find no row of its 16.
// Cin 4 (subm0 under the mean VFE) thus packs 4 taps into each k step on
// the same path. Rows are padded by 8 bfloat16 in shared memory, so the
// fragment loads of a warp hit 32 different banks. Staging: a thread
// issues all its 16 float4 row loads of a stage before the barrier that
// frees the buffers (under the other warps' products), then converts and
// stores them; W follows in batches of 8 column pairs, one bfloat162
// store a pair. With Cin a template constant the staging's index
// arithmetic is shifts (a first design with runtime divisions and one
// load at a time ran 1.6x slower than K4 on a car scan; this one runs at
// 189 registers, one block an SM: bounding it to two blocks spilled and
// ran 1.5x slower again, measured on the H100). The k order and
// the skips depend on the plan alone: two calls on the same inputs give
// the same bits. Shared memory: 74.5 KB at Cout 64.
#include <cuda_bf16.h>

namespace {

constexpr int kB16Threads = 256;            // 8 warps
constexpr int kB16KMax = 256;               // K columns a stage
constexpr int kB16Ld = kB16KMax + 8;        // bf16 a shared row (padded)

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

constexpr int smem_bytes_bf16(int cout) {
  return (kTile + cout) * kB16Ld * 2 + kTaps * kTile * 4;
}

// CIN > 0: the input width as a constant (the staging's index arithmetic
// becomes shifts and its loads unroll); 0: cin, any multiple of 4 up to 64
template <typename IdxT, int COUT, int CIN>
__global__ void __launch_bounds__(kB16Threads)
sparse_conv_bf16_kernel(const float* __restrict__ feats, int m_in, int cin_arg,
                        const IdxT* __restrict__ plan, int m_out,
                        const float* __restrict__ weight,
                        float* __restrict__ out) {
  const int cin = CIN > 0 ? CIN : cin_arg;
  constexpr int kGroups = kTile / 16;                  // 16-row groups
  constexpr int kWarpTiles = COUT / 8 / (kB16Threads / 32 / kGroups);
  // a thread's share of a stage: float4 pieces of the found rows, and
  // pairs of W entries (kB16KMax columns of 64 rows / of COUT rows)
  constexpr int kRowPieces = kTile * kB16KMax / 4 / kB16Threads;      // 16
  constexpr int kWPairs = COUT * kB16KMax / 2 / kB16Threads;    // 8..32
  constexpr int kWChunk = kWPairs < 8 ? kWPairs : 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][Ld]
  __nv_bfloat16* ws = xs + kTile * kB16Ld;                       // [COUT][Ld]
  int* src = reinterpret_cast<int*>(ws + COUT * kB16Ld);         // [27][64]
  __shared__ unsigned found[kGroups];   // taps found in each 16-row group
  __shared__ int taps[kTaps];           // the taps found in the tile
  __shared__ int n_taps;

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* fb = feats + static_cast<long long>(b) * m_in * cin;
  const IdxT* pb = plan + static_cast<long long>(b) * kTaps * m_out;
  if (tid < kGroups) found[tid] = 0u;
  __syncthreads();
  // the tile's plan entries; a warp's 32 entries are one tap's (kTile and
  // the block are multiples of 32), so the loop and the ballot are uniform
  for (int i = tid; i < kTaps * kTile; i += kB16Threads) {
    const int t = i / kTile;
    const int r = i - t * kTile;
    const int m = m0 + r;
    const int v = m < m_out
        ? static_cast<int>(pb[static_cast<long long>(t) * m_out + m]) : -1;
    src[i] = v;
    const unsigned hit = __ballot_sync(0xffffffffu, v >= 0);
    if (lane == 0) {
      if (hit & 0xffffu) atomicOr(&found[r >> 4], 1u << t);
      if (hit >> 16) atomicOr(&found[(r >> 4) + 1], 1u << t);
    }
  }
  __syncthreads();
  if (tid == 0) {
    unsigned any = 0u;
    for (int g = 0; g < kGroups; ++g) any |= found[g];
    int n = 0;
    for (int t = 0; t < kTaps; ++t) {
      if (any >> t & 1u) taps[n++] = t;
    }
    n_taps = n;
  }
  __syncthreads();

  const int g = lane >> 2;              // the fragments' row (col) group
  const int tig = lane & 3;
  const int rows0 = (warp % kGroups) * 16;
  const int tile0 = (warp / kGroups) * kWarpTiles;
  const unsigned mine = found[warp % kGroups];
  const int nt = n_taps;
  const int per_stage = kB16KMax / cin;
  const int c4 = cin >> 2;
  const int c2 = cin >> 1;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  float acc[kWarpTiles][4];
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  for (int j0 = 0; j0 < nt; j0 += per_stage) {
    const int ng = min(per_stage, nt - j0);
    const int kk = ng * cin;             // K columns of the stage
    const int kpad = (kk + 15) & ~15;
    // the found rows of the stage's taps, piece i = (tap j, row r, q):
    // all of a thread's loads first, so they are in flight together
    float4 v[kRowPieces];
#pragma unroll
    for (int k = 0; k < kRowPieces; ++k) {
      const int i = tid + k * kB16Threads;
      const int q = i % c4;
      const int r = (i / c4) % kTile;
      const int j = i / c4 / kTile;
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < ng) {
        const int s = src[taps[j0 + j] * kTile + r];
        if (s >= 0) {
          v[k] = *reinterpret_cast<const float4*>(
              fb + static_cast<long long>(s) * cin + 4 * q);
        }
      }
    }
    __syncthreads();                     // the last stage's fragments read
#pragma unroll
    for (int k = 0; k < kRowPieces; ++k) {
      const int i = tid + k * kB16Threads;
      const int q = i % c4;
      const int r = (i / c4) % kTile;
      const int j = i / c4 / kTile;
      if (j < ng) {
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(
            xs + r * kB16Ld + j * cin + 4 * q);
        d[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
        d[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
      }
    }
    // W[t] of the stage's taps as [COUT][K], a pair (c, c + 1) of one
    // output column n a thread, kWChunk pairs in flight at a time
#pragma unroll
    for (int k0 = 0; k0 < kWPairs; k0 += kWChunk) {
      float2 w[kWChunk];
#pragma unroll
      for (int k = 0; k < kWChunk; ++k) {
        const int i = tid + (k0 + k) * kB16Threads;
        const int n = i % COUT;
        const int c = 2 * ((i / COUT) % c2);
        const int j = i / COUT / c2;
        w[k] = make_float2(0.0f, 0.0f);
        if (j < ng) {
          const float* wt = weight +
              (static_cast<long long>(taps[j0 + j]) * cin + c) * COUT + n;
          w[k] = make_float2(wt[0], wt[COUT]);
        }
      }
#pragma unroll
      for (int k = 0; k < kWChunk; ++k) {
        const int i = tid + (k0 + k) * kB16Threads;
        const int n = i % COUT;
        const int c = 2 * ((i / COUT) % c2);
        const int j = i / COUT / c2;
        if (j < ng) {
          *reinterpret_cast<__nv_bfloat162*>(ws + n * kB16Ld + j * cin + c) =
              __floats2bfloat162_rn(w[k].x, w[k].y);
        }
      }
    }
    // the zero columns up to a multiple of 16
    const int pad = kpad - kk;
    for (int i = tid; i < (kTile + COUT) * pad; i += kB16Threads) {
      const int r = i / pad;
      const int c = kk + (i - r * pad);
      if (r < kTile) {
        xs[r * kB16Ld + c] = zero;
      } else {
        ws[(r - kTile) * kB16Ld + c] = zero;
      }
    }
    __syncthreads();
    const __nv_bfloat16* xa = xs + (rows0 + g) * kB16Ld + 2 * tig;
    for (int k0 = 0; k0 < kpad; k0 += 16) {
      // skip a k step whose taps find no row of this warp's 16
      const int ja = k0 / cin;
      const int jb = min(k0 + 15, kk - 1) / cin;
      unsigned cover = 0u;
      for (int j = ja; j <= jb; ++j) cover |= 1u << taps[j0 + j];
      if (!(mine & cover)) continue;
      unsigned a[4];
      a[0] = ld_bf16x2(xa + k0);
      a[1] = ld_bf16x2(xa + 8 * kB16Ld + k0);
      a[2] = ld_bf16x2(xa + k0 + 8);
      a[3] = ld_bf16x2(xa + 8 * kB16Ld + k0 + 8);
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        const __nv_bfloat16* wb =
            ws + ((tile0 + j) * 8 + g) * kB16Ld + k0 + 2 * tig;
        const unsigned bw[2] = {ld_bf16x2(wb), ld_bf16x2(wb + 8)};
        mma_bf16(acc[j], a, bw);
      }
    }
  }
  float* ob = out + static_cast<long long>(b) * m_out * COUT;
  const int r0 = m0 + rows0 + g;
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    const int col = (tile0 + j) * 8 + 2 * tig;
    if (r0 < m_out) {
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r0) * COUT +
                                 col) = make_float2(acc[j][0], acc[j][1]);
    }
    if (r0 + 8 < m_out) {
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r0 + 8) * COUT +
                                 col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

template <typename IdxT, int COUT, int CIN>
int launch_bf16_cin(const float* feats, int m_in, int cin, const IdxT* plan,
                    int batch, int m_out, const float* weight, float* out,
                    cudaStream_t s) {
  static bool done[64] = {};
  auto kernel = sparse_conv_bf16_kernel<IdxT, COUT, CIN>;
  const int bytes = smem_bytes_bf16(COUT);
  const int err = allow_smem(kernel, bytes, done);
  if (err != 0) return err;
  const dim3 grid((m_out + kTile - 1) / kTile, batch);
  kernel<<<grid, kB16Threads, bytes, s>>>(feats, m_in, cin, plan, m_out,
                                          weight, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdxT, int COUT>
int launch_bf16_cout(const float* feats, int m_in, int cin, const IdxT* plan,
                     int batch, int m_out, const float* weight, float* out,
                     cudaStream_t s) {
  switch (cin) {
    case 4:
      return launch_bf16_cin<IdxT, COUT, 4>(feats, m_in, cin, plan, batch,
                                            m_out, weight, out, s);
    case 16:
      return launch_bf16_cin<IdxT, COUT, 16>(feats, m_in, cin, plan, batch,
                                             m_out, weight, out, s);
    case 32:
      return launch_bf16_cin<IdxT, COUT, 32>(feats, m_in, cin, plan, batch,
                                             m_out, weight, out, s);
    case 64:
      return launch_bf16_cin<IdxT, COUT, 64>(feats, m_in, cin, plan, batch,
                                             m_out, weight, out, s);
    default:
      return launch_bf16_cin<IdxT, COUT, 0>(feats, m_in, cin, plan, batch,
                                            m_out, weight, out, s);
  }
}

template <typename IdxT>
int launch_bf16(const float* feats, int m_in, int cin, const IdxT* plan,
                int batch, int m_out, const float* weight, int cout,
                float* out, cudaStream_t s) {
  switch (cout) {
    case 16:
      return launch_bf16_cout<IdxT, 16>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    case 32:
      return launch_bf16_cout<IdxT, 32>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    case 64:
      return launch_bf16_cout<IdxT, 64>(feats, m_in, cin, plan, batch, m_out,
                                        weight, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sassd_sparse_conv's arguments and constraints, computed in bfloat16
// (K4-bf16): out [batch * m_out, cout] float32.
extern "C" int sassd_sparse_conv_bf16(const float* feats, int m_in, int cin,
                                      const void* plan, int plan_is_i16,
                                      int batch, int m_out,
                                      const float* weight, int cout,
                                      float* out, void* stream) {
  if (cin <= 0 || cin > kMaxCin || cin % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || m_out == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_is_i16) {
    return launch_bf16(feats, m_in, cin, static_cast<const short*>(plan),
                       batch, m_out, weight, cout, out, s);
  }
  return launch_bf16(feats, m_in, cin, static_cast<const int*>(plan), batch,
                     m_out, weight, cout, out, s);
}
