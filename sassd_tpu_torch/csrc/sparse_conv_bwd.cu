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
// Bound on the H100: operations. Only the found slots multiply: at the car
// config's L2 (2 x 14336 rows, 64 -> 64) about a fifth of the 27 x rows
// slots, 2 * found * Cin * Cout ~1.2 GFLOP of fp32 FMA, while the bytes
// (X and d_out read once) take a few us. The TPU version materialised the
// im2col and ran one MXU matmul; the [M, 27*Cin] matrix never exists here.
//
// Design, four launches in one call, no atomics, a fixed summation order:
// 1. count: one block per (1024 rows of a sample, tap) counts the found
//    slots;
// 2. compact: the same blocks rank their found rows by a block scan after
//    the counts of the earlier blocks of the tap, and write each tap's
//    (input row, output row) pairs in ascending output row, with the tap's
//    total: zero rows are never staged or multiplied afterwards;
// 3. products: a fixed grid of blocks (264, two an SM), each taking an
//    equal share of all taps' found pairs laid end to end, so the centre
//    tap (found for every active row) does not make the tail. A block
//    stages 64 pairs of one tap at a time, their X and d_out rows, with
//    16-byte cp.async into one of two shared-memory buffers (the next 64
//    load under this step's products), and each thread owns a 4x4
//    micro-tile of the [Cin, Cout] output: per staged row two 16-byte
//    shared loads and 16 FMAs. Where Cin * Cout / 16 < 256 threads, groups
//    of threads take every G-th row and are summed in group order. At the
//    end of each tap in its share a block writes one [Cin, Cout] partial;
// 4. sum: dW[t] = the partials of the blocks that touched tap t, summed in
//    a fixed order: 8 threads an output each sum a run of consecutive
//    blocks, then the runs are added in order.
// The shares follow from the counts alone, so two calls on the same inputs
// give bitwise-equal dW. Scratch: the pair list (27 x rows x 8 bytes,
// written only at found slots) and [264 + 27, Cin, Cout] partials whatever
// the rows. At 64 -> 64 the products take most of the time; the count,
// compact and sum passes a few us each.
#include <cuda_runtime.h>

namespace {

constexpr int kScan = 1024;          // flat rows per count/compact block
constexpr int kThreads = 256;
constexpr int kRows = 64;            // pairs staged per step
constexpr int kMaxC = 64;
constexpr int kTaps = 27;
constexpr int kPieces = kRows * (kMaxC / 4) / kThreads;   // 16-byte copies

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

// block x of the count and compact passes covers plan rows m =
// (x % m_chunks) * kScan + threadIdx.x of sample b = x / m_chunks, so the
// blocks run over the flat output rows in ascending order
template <typename IdxT>
__device__ __forceinline__ int plan_entry(const IdxT* plan, int t, int m_out,
                                          int m_chunks, int* g) {
  const int b = blockIdx.x / m_chunks;
  const int m = (blockIdx.x - b * m_chunks) * kScan + threadIdx.x;
  *g = b * m_out + m;
  if (m >= m_out) return -1;
  return static_cast<int>(
      plan[(static_cast<long long>(b) * kTaps + t) * m_out + m]);
}

template <typename IdxT>
__global__ void __launch_bounds__(kScan)
count_kernel(const IdxT* __restrict__ plan, int m_out, int m_chunks,
             int* __restrict__ counts) {
  int g;
  const bool found = plan_entry(plan, blockIdx.y, m_out, m_chunks, &g) >= 0;
  const int n = __syncthreads_count(found);
  if (threadIdx.x == 0) counts[blockIdx.y * gridDim.x + blockIdx.x] = n;
}

template <typename IdxT>
__global__ void __launch_bounds__(kScan)
compact_kernel(const IdxT* __restrict__ plan, int m_in, int m_out,
               int m_chunks, int rows, const int* __restrict__ counts,
               int2* __restrict__ pairs, int* __restrict__ totals) {
  __shared__ int warp_off[kScan / 32];
  __shared__ int base;
  const int t = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    int s = 0;
    for (int c = lane; c < chunk; c += 32) s += counts[t * gridDim.x + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) base = s;
  }
  int g;
  const int p = plan_entry(plan, t, m_out, m_chunks, &g);
  const unsigned found = __ballot_sync(0xffffffffu, p >= 0);
  if (lane == 0) warp_off[warp] = __popc(found);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_off[lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_off[lane] = x - v;                       // exclusive
    if (lane == 31 && chunk == gridDim.x - 1) totals[t] = base + x;
  }
  __syncthreads();
  if (p >= 0) {
    const int rank = base + warp_off[warp] +
                     __popc(found & ((1u << lane) - 1u));
    pairs[static_cast<long long>(t) * rows + rank] =
        make_int2(chunk / m_chunks * m_in + p, g);
  }
}

// prefix[t] = found pairs of the taps before t, prefix[27] = all of them
__device__ void tap_prefix(const int* __restrict__ totals, int* prefix) {
  if (threadIdx.x == 0) {
    int s = 0;
    for (int t = 0; t < kTaps; ++t) {
      prefix[t] = s;
      s += totals[t];
    }
    prefix[kTaps] = s;
  }
  __syncthreads();
}

// the first pair of block b's equal share of all `total` found pairs
__device__ __forceinline__ int share_start(long long total, int b,
                                           int blocks) {
  return static_cast<int>(total * b / blocks);
}

// one step of a block: up to kRows consecutive pairs of one tap, starting
// at position q of the taps' pairs laid end to end (n = 0: none left)
struct Step {
  int t, q, n;
};

__device__ __forceinline__ Step next_step(const int* prefix, int q, int t,
                                          int hi) {
  while (t < kTaps && prefix[t + 1] <= q) ++t;
  if (q >= hi || t >= kTaps) return Step{t, q, 0};
  return Step{t, q, min(kRows, min(hi, prefix[t + 1]) - q)};
}

__global__ void __launch_bounds__(kThreads)
products_kernel(const float* __restrict__ feats, int cin,
                const float* __restrict__ d_out, int cout,
                const int2* __restrict__ pairs, int rows,
                const int* __restrict__ totals, int buf_floats,
                float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // 2 x [X rows, d_out rows]
  __shared__ int prefix[kTaps + 1];
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  tap_prefix(totals, prefix);
  const int total = prefix[kTaps];
  const int lo = share_start(total, blk, gridDim.x);
  const int hi = share_start(total, blk + 1, gridDim.x);
  const int c4 = cin / 4;
  const int o4 = cout / 4;
  const int ntiles = c4 * o4;
  const int groups = kThreads / ntiles;
  const int grp = tid / ntiles;
  const int tile = tid - grp * ntiles;
  const int ci0 = (tile / o4) * 4;
  const int co0 = (tile % o4) * 4;

  // the source rows of this thread's 16-byte copies of one step: X pieces
  // i = tid + k * 256 of kRows * c4, d_out pieces of kRows * o4
  int xrow[kPieces], drow[kPieces];
  auto load_rows = [&](const Step& st) {
    const int2* pt = pairs + static_cast<long long>(st.t) * rows +
                     (st.q - prefix[st.t]);
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int i = tid + k * kThreads;
      const int rx = i / c4;
      const int rd = i / o4;
      xrow[k] = rx < st.n ? pt[rx].x : -1;
      drow[k] = rd < st.n ? pt[rd].y : -1;
    }
  };
  auto issue = [&](int j) {
    float* xd = smem + (j & 1) * buf_floats;
    float* dd = xd + kRows * cin;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int i = tid + k * kThreads;
      if (xrow[k] >= 0) {
        const int r = i / c4;
        const int q = i - r * c4;
        cp_async16(xd + r * cin + 4 * q,
                   feats + static_cast<long long>(xrow[k]) * cin + 4 * q);
      }
      if (drow[k] >= 0) {
        const int r = i / o4;
        const int q = i - r * o4;
        cp_async16(dd + r * cout + 4 * q,
                   d_out + static_cast<long long>(drow[k]) * cout + 4 * q);
      }
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }
  Step cur = next_step(prefix, lo, 0, hi);
  Step nxt = next_step(prefix, cur.q + cur.n, cur.t, hi);
  Step nx2 = next_step(prefix, nxt.q + nxt.n, nxt.t, hi);
  if (cur.n > 0) {
    load_rows(cur);
    issue(0);
  }
  if (nxt.n > 0) load_rows(nxt);
  for (int j = 0; cur.n > 0; ++j) {
    if (nxt.n > 0) issue(j + 1);
    if (nx2.n > 0) load_rows(nx2);
    if (nxt.n > 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* xb = smem + (j & 1) * buf_floats;
    if (grp < groups) {
      const float* xr = xb + ci0;
      const float* dr = xb + kRows * cin + co0;
      for (int r = grp; r < cur.n; r += groups) {
        const float4 x = *reinterpret_cast<const float4*>(xr + r * cin);
        const float4 d = *reinterpret_cast<const float4*>(dr + r * cout);
        const float xv[4] = {x.x, x.y, x.z, x.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[a][c] = __fmaf_rn(xv[a], dv[c], acc[a][c]);
          }
        }
      }
    }
    __syncthreads();
    if (nxt.n == 0 || nxt.t != cur.t) {
      // the block's last step of tap cur.t: its groups' sums, added in
      // group order, go to partial slot blk + cur.t (unique: along a
      // block's steps and across blocks both the block and the tap only
      // grow, one at least with every new (block, tap) pair)
      const int n_out = cin * cout;
      float* red = xb;                               // [groups][cin][cout]
      if (grp < groups) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            red[grp * n_out + (ci0 + a) * cout + co0 + c] = acc[a][c];
            acc[a][c] = 0.0f;
          }
        }
      }
      __syncthreads();
      float* dst = partial + static_cast<long long>(blk + cur.t) * n_out;
      for (int e = tid; e < n_out; e += kThreads) {
        float sum = red[e];
        for (int g = 1; g < groups; ++g) sum += red[g * n_out + e];
        dst[e] = sum;
      }
      __syncthreads();
    }
    cur = nxt;
    nxt = nx2;
    nx2 = next_step(prefix, nx2.q + nx2.n, nx2.t, hi);
  }
}

// the block whose share of `total` pairs holds position q: the last b
// with share_start(b) <= q
__device__ __forceinline__ int share_of(long long q, long long total,
                                        int blocks) {
  const long long x = (q + 1) * blocks;
  return static_cast<int>(x / total + (x % total != 0)) - 1;
}

constexpr int kSumOuts = 32;          // outputs of a sum block
constexpr int kSumParts = 8;          // threads an output, each 33 blocks

// dw[t] = the partials of the blocks whose share holds pairs of tap t,
// summed in block order (kSumParts runs of consecutive blocks, then the
// runs in order); 0 for a tap that finds no row
__global__ void __launch_bounds__(kSumOuts * kSumParts)
sum_kernel(const int* __restrict__ totals, const float* __restrict__ partial,
           int n_out, int blocks, float* __restrict__ dw) {
  __shared__ int prefix[kTaps + 1];
  __shared__ float runs[kSumParts][kSumOuts];
  tap_prefix(totals, prefix);
  const int o = threadIdx.x % kSumOuts;
  const int part = threadIdx.x / kSumOuts;
  const int e = blockIdx.x * kSumOuts + o;
  const int t = min(e / n_out, kTaps - 1);
  const int total = prefix[kTaps];
  float s = 0.0f;
  if (e < kTaps * n_out && prefix[t + 1] > prefix[t]) {
    const int per = (blocks + kSumParts - 1) / kSumParts;
    const int b0 = max(share_of(prefix[t], total, blocks), part * per);
    const int b1 = min(share_of(prefix[t + 1] - 1, total, blocks),
                       part * per + per - 1);
    const float* src = partial + e;     // slot b + t, element e - t * n_out
    if (total >= blocks) {            // then no share is empty
      for (int b = b0; b <= b1; ++b) {
        s += src[static_cast<long long>(b) * n_out];
      }
    } else {
      for (int b = b0; b <= b1; ++b) {
        if (share_start(total, b, blocks) <
            share_start(total, b + 1, blocks)) {
          s += src[static_cast<long long>(b) * n_out];
        }
      }
    }
  }
  runs[part][o] = s;
  __syncthreads();
  if (part == 0 && e < kTaps * n_out) {
    float sum = runs[0][o];
    for (int p = 1; p < kSumParts; ++p) sum += runs[p][o];
    dw[e] = sum;
  }
}

int buffer_floats(int cin, int cout) {
  const int stage = kRows * (cin + cout);
  return stage > kThreads * 16 ? stage : kThreads * 16;
}

template <typename IdxT>
int launch(const float* feats, int m_in, int cin, const IdxT* plan,
           int batch, int m_out, const float* d_out, int cout, int blocks,
           int* counts, int2* pairs, int* totals, float* partial, float* dw,
           cudaStream_t s) {
  const int m_chunks = (m_out + kScan - 1) / kScan;
  const dim3 scan_grid(batch * m_chunks, kTaps);
  count_kernel<IdxT><<<scan_grid, kScan, 0, s>>>(plan, m_out, m_chunks,
                                                 counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<IdxT><<<scan_grid, kScan, 0, s>>>(
      plan, m_in, m_out, m_chunks, batch * m_out, counts, pairs, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int buf = buffer_floats(cin, cout);
  const int bytes = 2 * buf * 4;
  {
    static bool done[64] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!done[dev]) {
      err = cudaFuncSetAttribute(products_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 2 * buffer_floats(kMaxC, kMaxC) * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      done[dev] = true;
    }
  }
  products_kernel<<<blocks, kThreads, bytes, s>>>(
      feats, cin, d_out, cout, pairs, batch * m_out, totals, buf, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = cin * cout;
  sum_kernel<<<(kTaps * n_out + kSumOuts - 1) / kSumOuts,
               kSumOuts * kSumParts, 0, s>>>(totals, partial, n_out, blocks,
                                             dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [batch * m_in, cin] float32 (16-byte aligned); plan [batch, 27,
// m_out] int16 (plan_is_i16 != 0) or int32; d_out [batch * m_out, cout]
// float32 (16-byte aligned); cin and cout multiples of 4 up to 64; blocks
// in 1..65535. Scratch: counts [27 * batch * ceil(m_out / 1024)] int32,
// totals [27] int32, pairs [27, batch * m_out] int32 x 2 (8-byte aligned),
// partial [blocks + 27, cin, cout] float32. dw [27, cin, cout].
extern "C" int sassd_sparse_conv_dw(const float* feats, int m_in, int cin,
                                    const void* plan, int plan_is_i16,
                                    int batch, int m_out, const float* d_out,
                                    int cout, int blocks, int* counts,
                                    int* totals, void* pairs, float* partial,
                                    float* dw, void* stream) {
  if (cin <= 0 || cin > kMaxC || cin % 4 || cout <= 0 || cout > kMaxC ||
      cout % 4 || blocks <= 0 || blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m_out == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * kTaps * cin * cout, s);
    return static_cast<int>(cudaGetLastError());
  }
  int2* p2 = static_cast<int2*>(pairs);
  if (plan_is_i16) {
    return launch(feats, m_in, cin, static_cast<const short*>(plan), batch,
                  m_out, d_out, cout, blocks, counts, p2, totals, partial, dw,
                  s);
  }
  return launch(feats, m_in, cin, static_cast<const int*>(plan), batch, m_out,
                d_out, cout, blocks, counts, p2, totals, partial, dw, s);
}
