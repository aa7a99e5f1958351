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
// Operands: rounded once a call, before any product, as JAX's astype
// does (rounding is elementwise, so rounding before the gather gives the
// same bits): the features to a bfloat16 copy [B * M_in, Cin] and W to a
// bfloat16 panel [27][Cout][Kp], Kp = Cin rounded up to 16 with zeros past
// Cin, each 16 input channels in the order of an mma B fragment (0 1 8 9 2
// 3 10 11 4 5 12 13 6 7 14 15), so a lane's two B registers of a k step
// are one 8-byte load. W is read through its strides, its taps reversed
// for a submanifold conv's input gradient, its columns past the real ones
// zero (the 4-wide input gradient's 16): the transposes and the padding
// of the input gradients' weights cost no copy. The rounding is the first
// phase of the one cooperative launch (every block resident): the whole
// grid rounds, grid-stride (each element once, not once a block), then
// waits at a grid barrier, and only then does any block gather or
// multiply. (As torch ops, or as a launch of its own, the rounding cost
// more host time a call than the conv's device time at most shapes;
// measured on the H100.)
//
// Bound on the H100: the bytes (the features, the plan and the panel read
// once, the output written once); the found slots' 2 * found * Cin * Cout
// operations at 989 TFLOP/s (dense bf16) take well under a microsecond at
// every car shape. Below the bytes, the latency of the row gathers.
//
// Design (output-stationary, no atomics): after the rounding, a block
// takes 32-row tiles (blockIdx.x, + gridDim.x, ... of the batch's tiles);
// for each it owns the 32 output rows and every output channel, their
// float32 sums in shared memory, with one warp per 8 output columns (Cout
// / 8 warps). It compacts
// the tile's plan as K4 does (a warp ballot and prefix count per tap: the
// found rows and their input rows) and cuts each tap's found rows into
// 16-row mma groups, a tap's last group short; a tile of padding rows has
// no group and writes zeros. The groups run in tap order, 8 a stage. A
// stage copies only its groups' found rows, straight from the bfloat16
// copy with 16-byte (Cin 4: 8-byte) cp.async, into a ring of three
// shared-memory buffers, two stages ahead of the products, one barrier a
// stage; the unused rows of a short group are never loaded or zeroed (an
// mma's output row depends on its input row alone, and those outputs are
// dropped). For each group of a stage a warp loads its 8 columns of W[t]
// from the panel (issued before the stage's wait, so they arrive under
// it), reads the group's rows' sums as the mma's C, runs ceil(Cin / 16)
// mma.sync.m16n8k16 steps on A fragments read from the staged rows by
// ldmatrix, and stores the sums back. A warp owns its columns of every
// row and takes the groups in order, so no two warps touch one sum and
// every output element is one chain over its found taps t = 0..26 (each
// tap's products summed by the tensor core): the order depends on the
// plan alone, and two calls on the same inputs give the same bits. Cin 4
// (subm0 under the mean VFE) runs one k step with zero channels 4..15
// (zeroed once in the buffers, zero in the panel). What bounds it
// (measured on the H100 by switching parts off, L2 64 -> 64): the wait
// for each stage's gathered rows and each warp's chain of groups (its
// sums read, multiplied and stored group after group), not the panel's
// reads; 32-row tiles halve that chain against 64 and the ring keeps two
// stages of rows in flight. The first design (PR 20) staged all 64 rows
// of the tile for every tap found in it, converted W[t] in every block
// and ran at 189 registers, one block an SM. Shared memory at Cin 64,
// Cout 64: 67.2 KB.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB16Tile = 32;                       // output rows a block
constexpr int kB16StageGroups = 8;                 // 16-row groups a stage
constexpr int kB16Slots = 16 * kB16StageGroups;    // staged rows a stage
constexpr int kB16Ring = 3;                        // stages in shared memory
constexpr int kB16MaxGroups = kTaps * (kB16Tile / 16);

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a row of the sums, floats: 8 past Cout, so that the 8 rows of a
// fragment spread over the banks
__host__ __device__ constexpr int acc_ld(int cout) { return cout + 8; }

// dynamic shared memory: the sums, a ring of stage buffers of rows of Kp
// + 8 bfloat16 (the pad spreads ldmatrix's rows over the banks) and the
// compacted lists (input row, tile row) of every tap
constexpr int smem_bytes_bf16(int ks, int cout) {
  return kB16Tile * acc_ld(cout) * 4 +
         kB16Ring * kB16Slots * (16 * ks + 8) * 2 + kTaps * kB16Tile * 4 +
         kTaps * kB16Tile;
}

// The operands' pass, grid-stride over the whole grid (i: this thread's
// rank in it, step: the grid's threads): the features rounded to the
// bfloat16 copy, 4 values a thread, then the panel. Panel tap t is W's
// tap t (26 - t where the taps are reversed), element (n, k) at W + t s_t
// + k s_k + n s_n; zero past the input channels and n_real columns.
__device__ void round_operands(const float* __restrict__ feats, long long n4,
                               const float* __restrict__ weight, int s_t,
                               int s_k, int s_n, int reversed, int cin,
                               int n_real, int n_cols, int kp, long long i,
                               long long step,
                               __nv_bfloat16* __restrict__ feats16,
                               __nv_bfloat16* __restrict__ panel) {
  for (long long j = i; j < n4; j += step) {
    const float4 v = reinterpret_cast<const float4*>(feats)[j];
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(feats16) + 2 * j;
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (long long j = i; j < static_cast<long long>(kTaps) * n_cols * kp;
       j += step) {
    const int e = static_cast<int>(j);
    const int t = e / (n_cols * kp);
    const int n = (e / kp) % n_cols;
    const int pos = e % kp;
    // position 16 s + 4 q + 2 h + p holds channel 16 s + 8 h + 2 q + p
    const int k = (pos & ~15) + 8 * ((pos >> 1) & 1) + 2 * ((pos >> 2) & 3) +
                  (pos & 1);
    float v = 0.0f;
    if (k < cin && n < n_real) {
      v = weight[static_cast<long long>(reversed ? kTaps - 1 - t : t) * s_t +
                 static_cast<long long>(k) * s_k +
                 static_cast<long long>(n) * s_n];
    }
    panel[e] = __float2bfloat16_rn(v);
  }
}

// KS: k steps of 16 input channels, ceil(cin / 16)
template <typename IdxT, int COUT, int KS>
__global__ void __launch_bounds__(COUT * 4)
sparse_conv_bf16_kernel(const float* __restrict__ feats32, long long n4,
                        const float* __restrict__ weight, int s_t, int s_k,
                        int s_n, int reversed, int n_real,
                        __nv_bfloat16* __restrict__ feats,
                        __nv_bfloat16* __restrict__ panel, int m_in, int cin,
                        const IdxT* __restrict__ plan, int m_out,
                        int tiles, int batch, float* __restrict__ out) {
  constexpr int kThr = COUT * 4;
  constexpr int kWarps = COUT / 8;
  constexpr int kKp = 16 * KS;             // a panel row, input channels
  constexpr int kLd = kKp + 8;             // a staged row, bfloat16
  constexpr int kAcc = acc_ld(COUT);
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);                 // [32][kAcc]
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(acc + kB16Tile * kAcc);  // [3][128][kLd]
  int* lsrc = reinterpret_cast<int*>(xs + kB16Ring * kB16Slots * kLd);
  unsigned char* lrow =
      reinterpret_cast<unsigned char*>(lsrc + kTaps * kB16Tile);
  __shared__ int cnt[kTaps];
  __shared__ unsigned char gtap[kB16MaxGroups];  // a group's tap
  __shared__ unsigned char gi0[kB16MaxGroups];   // its first row in the list
  __shared__ int n_groups;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the operands, rounded once by the whole grid, then a grid barrier (the
  // launch is cooperative: every block is resident)
  round_operands(feats32, n4, weight, s_t, s_k, s_n, reversed, cin, n_real,
                 COUT, kKp, blockIdx.x * static_cast<long long>(kThr) + tid,
                 static_cast<long long>(gridDim.x) * kThr, feats, panel);
  // the channels past cin of every staged row: zero once (no copy writes
  // them)
  const int pad = kKp - cin;
  if (pad > 0) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < kB16Ring * kB16Slots * pad; i += kThr) {
      const int r = i / pad;
      xs[r * kLd + cin + (i - r * pad)] = zero;
    }
  }
  cooperative_groups::this_grid().sync();

  // the tiles, blockIdx.x, + gridDim.x, ... of batch x tiles
  for (int tile = blockIdx.x; tile < batch * tiles; tile += gridDim.x) {
    const int b = tile / tiles;
    const int m0 = (tile - b * tiles) * kB16Tile;
    const __nv_bfloat16* fb = feats + static_cast<long long>(b) * m_in * cin;
    const IdxT* pb = plan + static_cast<long long>(b) * kTaps * m_out;

    // compaction: warp w lists the found rows of taps w, w + kWarps, ...
    // (its plan entries are loaded first, all at once)
    constexpr int kWarpTaps = (kTaps + kWarps - 1) / kWarps;
    int src[kWarpTaps][kB16Tile / 32];
#pragma unroll
    for (int k = 0; k < kWarpTaps; ++k) {
      const int t = warp + k * kWarps;
#pragma unroll
      for (int h = 0; h < kB16Tile / 32; ++h) {
        const int m = m0 + h * 32 + lane;
        src[k][h] = t < kTaps && m < m_out
            ? static_cast<int>(pb[static_cast<long long>(t) * m_out + m]) : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kWarpTaps; ++k) {
      const int t = warp + k * kWarps;
      if (t >= kTaps) break;
      int base = 0;
#pragma unroll
      for (int h = 0; h < kB16Tile / 32; ++h) {
        const unsigned found = __ballot_sync(0xffffffffu, src[k][h] >= 0);
        if (src[k][h] >= 0) {
          const int at = base + __popc(found & ((1u << lane) - 1u));
          lsrc[t * kB16Tile + at] = src[k][h];
          lrow[t * kB16Tile + at] = static_cast<unsigned char>(h * 32 + lane);
        }
        base += __popc(found);
      }
      if (lane == 0) cnt[t] = base;
    }
    for (int i = tid; i < kB16Tile * kAcc / 4; i += kThr) {
      smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    // the groups in tap order: lane t of warp 0 places tap t's
    if (warp == 0) {
      const int c = lane < kTaps ? cnt[lane] : 0;
      const int ng = (c + 15) >> 4;
      int x = ng;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      for (int q = 0; q < ng; ++q) {
        gtap[x - ng + q] = static_cast<unsigned char>(lane);
        gi0[x - ng + q] = static_cast<unsigned char>(16 * q);
      }
      if (lane == 31) n_groups = x;
    }
    __syncthreads();

    const int ng = n_groups;
    const int n_stages = (ng + kB16StageGroups - 1) / kB16StageGroups;
    const bool wide = (cin & 7) == 0;           // 16-byte copies, else 8-byte
    const int pieces = wide ? cin >> 3 : cin >> 2;
    // stage s: the found rows of groups 8s .. 8s + 7 into buffer s % 3,
    // group j's row i at slot 16 (j - 8s) + i (none past the last group:
    // an empty commit group keeps the waits' count)
    auto stage = [&](int s) {
      __nv_bfloat16* xd = xs + (s % kB16Ring) * kB16Slots * kLd;
      const int g0 = s * kB16StageGroups;
      const int slots = max(0, min(kB16StageGroups, ng - g0)) * 16;
      for (int i = tid; i < slots * pieces; i += kThr) {
        const int slot = i / pieces;
        const int q = i - slot * pieces;
        const int j = g0 + (slot >> 4);
        const int t = gtap[j];
        const int r = gi0[j] + (slot & 15);
        if (r < cnt[t]) {
          const long long row = lsrc[t * kB16Tile + r];
          if (wide) {
            cp_async16(xd + slot * kLd + 8 * q, fb + row * cin + 8 * q);
          } else {
            cp_async8(xd + slot * kLd + 4 * q, fb + row * cin + 4 * q);
          }
        }
      }
      cp_async_commit();
    };

    const int g = lane >> 2;
    const int tig = lane & 3;
    const int n0 = warp * 8;
    // ldmatrix.x4 of a group's 16 x 16 A tile: lane l names row l % 16 at
    // column 8 (l / 16): the four 8 x 8 matrices are a0..a3
    const int a_off = (lane & 15) * kLd + (lane >> 4) * 8;
    // stages s + 1 .. s + 2 copy while stage s multiplies
    for (int s = 0; s < kB16Ring - 1; ++s) stage(s);
    for (int s = 0; s < n_stages; ++s) {
      const int g0 = s * kB16StageGroups;
      const int n_here = min(kB16StageGroups, ng - g0);
      // this warp's B fragments of the stage's groups: lane (g, tig) holds
      // column n0 + g, channels 16k + {2tig, 2tig + 1, 2tig + 8, 2tig + 9}
      uint2 bw[kB16StageGroups][KS];
#pragma unroll
      for (int jj = 0; jj < kB16StageGroups; ++jj) {
        if (jj < n_here) {
          const uint2* wp = reinterpret_cast<const uint2*>(
              panel + (static_cast<long long>(gtap[g0 + jj]) * COUT + n0 + g) *
                          kKp + 4 * tig);
#pragma unroll
          for (int k = 0; k < KS; ++k) bw[jj][k] = wp[4 * k];
        } else {
#pragma unroll
          for (int k = 0; k < KS; ++k) bw[jj][k] = make_uint2(0u, 0u);
        }
      }
      cp_async_wait<kB16Ring - 2>();
      __syncthreads();      // stage s is in; every warp is done with s - 1
      stage(s + kB16Ring - 1);        // into s - 1's buffer
      // the tile rows of this lane's two fragment rows in each group, -1
      // past the group's found rows
      int ra[kB16StageGroups], rb[kB16StageGroups];
#pragma unroll
      for (int jj = 0; jj < kB16StageGroups; ++jj) {
        ra[jj] = rb[jj] = -1;
        if (jj < n_here) {
          const int t = gtap[g0 + jj];
          const int i0 = gi0[g0 + jj];
          const int n = cnt[t] - i0;
          const unsigned char* lr = lrow + t * kB16Tile + i0;
          if (g < n) ra[jj] = lr[g];
          if (g + 8 < n) rb[jj] = lr[g + 8];
        }
      }
      const __nv_bfloat16* xb =
          xs + (s % kB16Ring) * kB16Slots * kLd + a_off;
#pragma unroll
      for (int jj = 0; jj < kB16StageGroups; ++jj) {
        if (jj >= n_here) break;
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float2* pa = reinterpret_cast<float2*>(acc + max(ra[jj], 0) * kAcc +
                                               n0 + 2 * tig);
        float2* pc = reinterpret_cast<float2*>(acc + max(rb[jj], 0) * kAcc +
                                               n0 + 2 * tig);
        if (ra[jj] >= 0) {
          const float2 v = *pa;
          c[0] = v.x;
          c[1] = v.y;
        }
        if (rb[jj] >= 0) {
          const float2 v = *pc;
          c[2] = v.x;
          c[3] = v.y;
        }
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          unsigned a[4];
          ldmatrix_x4(a, xb + jj * 16 * kLd + 16 * k);
          const unsigned bb[2] = {bw[jj][k].x, bw[jj][k].y};
          mma_bf16(c, a, bb);
        }
        if (ra[jj] >= 0) *pa = make_float2(c[0], c[1]);
        if (rb[jj] >= 0) *pc = make_float2(c[2], c[3]);
        __syncwarp();       // the next group's rows may be this one's
      }
    }
    __syncthreads();
    const int rows = min(kB16Tile, m_out - m0);
    float4* ob = reinterpret_cast<float4*>(
        out + (static_cast<long long>(b) * m_out + m0) * COUT);
    for (int i = tid; i < rows * COUT / 4; i += kThr) {
      const int r = i / (COUT / 4);
      ob[i] = smem4[r * (kAcc / 4) + (i - r * (COUT / 4))];
    }
    __syncthreads();      // the sums and lists are free for the next tile
  }
}

// the arguments of one K4-bf16 launch
struct Bf16Args {
  const float* feats32;
  long long n4;
  const float* weight;
  int s_t, s_k, s_n, reversed, n_real;
  __nv_bfloat16* feats;
  __nv_bfloat16* panel;
  int m_in, cin;
  const void* plan;
  int m_out, tiles, batch;
  float* out;
};

// one cooperative launch of a grid of every block the card holds at once
// (at most one a tile), sized once per device
template <typename IdxT, int COUT, int KS>
int launch_bf16_ks(Bf16Args a, cudaStream_t s) {
  static bool done[64] = {};
  static int resident[64] = {};
  auto kernel = sparse_conv_bf16_kernel<IdxT, COUT, KS>;
  const int bytes = smem_bytes_bf16(KS, COUT);
  int err = allow_smem(kernel, bytes, done);
  if (err != 0) return err;
  int dev = 0;
  cudaGetDevice(&dev);       // allow_smem checked it
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, COUT * 4, bytes);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int work = a.batch * a.tiles;
  const int grid = work < resident[dev] ? work : resident[dev];
  const IdxT* plan = static_cast<const IdxT*>(a.plan);
  void* args[] = {&a.feats32, &a.n4,     &a.weight, &a.s_t,   &a.s_k,
                  &a.s_n,     &a.reversed, &a.n_real, &a.feats, &a.panel,
                  &a.m_in,    &a.cin,    &plan,     &a.m_out, &a.tiles,
                  &a.batch,   &a.out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(grid), dim3(COUT * 4), args, bytes, s));
}

template <typename IdxT, int COUT>
int launch_bf16_cout(const Bf16Args& a, cudaStream_t s) {
  switch ((a.cin + 15) / 16) {
    case 1:
      return launch_bf16_ks<IdxT, COUT, 1>(a, s);
    case 2:
      return launch_bf16_ks<IdxT, COUT, 2>(a, s);
    case 3:
      return launch_bf16_ks<IdxT, COUT, 3>(a, s);
    default:
      return launch_bf16_ks<IdxT, COUT, 4>(a, s);
  }
}

template <typename IdxT>
int launch_bf16(const Bf16Args& a, int cout, cudaStream_t s) {
  switch (cout) {
    case 16:
      return launch_bf16_cout<IdxT, 16>(a, s);
    case 32:
      return launch_bf16_cout<IdxT, 32>(a, s);
    default:
      return launch_bf16_cout<IdxT, 64>(a, s);
  }
}

}  // namespace

// K4-bf16: sassd_sparse_conv's feats, plan and out, with W [27, cin,
// n_real] float32 read through its strides (in elements; taps_reversed:
// panel tap t is W's tap 26 - t) into cout in {16, 32, 64} >= n_real
// output columns (zero past n_real). work (16-byte aligned): the rounded
// features, batch * m_in * cin bfloat16 rounded up to 16 bytes, then the
// panel, 27 * cout * ceil(cin / 16) * 16 bfloat16.
extern "C" int sassd_sparse_conv_bf16(const float* feats, int m_in, int cin,
                                      const void* plan, int plan_is_i16,
                                      int batch, int m_out,
                                      const float* weight, int w_tap_stride,
                                      int w_k_stride, int w_n_stride,
                                      int taps_reversed, int n_real,
                                      int cout, void* work, float* out,
                                      void* stream) {
  if (cin <= 0 || cin > kMaxCin || cin % 4 != 0 || n_real <= 0 ||
      n_real > cout || (cout != 16 && cout != 32 && cout != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || m_out == 0) return static_cast<int>(cudaGetLastError());
  const long long rows = static_cast<long long>(batch) * m_in;
  Bf16Args a;
  a.feats32 = feats;
  a.n4 = rows * cin / 4;
  a.weight = weight;
  a.s_t = w_tap_stride;
  a.s_k = w_k_stride;
  a.s_n = w_n_stride;
  a.reversed = taps_reversed;
  a.n_real = n_real;
  a.feats = static_cast<__nv_bfloat16*>(work);
  a.panel = reinterpret_cast<__nv_bfloat16*>(
      static_cast<char*>(work) + (rows * cin * 2 + 15) / 16 * 16);
  a.m_in = m_in;
  a.cin = cin;
  a.plan = plan;
  a.m_out = m_out;
  a.tiles = (m_out + kB16Tile - 1) / kB16Tile;
  a.batch = batch;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_is_i16) return launch_bf16<short>(a, cout, s);
  return launch_bf16<int>(a, cout, s);
}
