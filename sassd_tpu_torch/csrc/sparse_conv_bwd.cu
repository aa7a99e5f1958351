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
//
// K10-bf16 (sassd_sparse_conv_dw_bf16, model.compute_dtype="bfloat16"):
// the dW half of _subm_conv_sym_bwd / _stride_hostT_bwd with
// compute_dtype=bfloat16, dW = bf16(col)^T . bf16(d_out) with float32 sums
// (jnp.dot(..., preferred_element_type=float32)). The same four passes
// and scratch, with X and d_out rounded to bfloat16 copies once a call in
// pass 1 (JAX's astype; the rounding commutes with the gather), pass 3
// being products_bf16_kernel (tensor-core mma.sync on rows staged as they
// lie, below), which writes the same partial slots, so dW keeps the fixed
// summation order across blocks and is bitwise equal over calls. Bound:
// the bytes, as its 2 * found * Cin * Cout operations at 989 TFLOP/s
// (dense bf16) take about 1 us at the largest car shape.
#include <cuda_bf16.h>
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

// one step of a block: up to R consecutive pairs of one tap, starting
// at position q of the taps' pairs laid end to end (n = 0: none left)
struct Step {
  int t, q, n;
};

template <int R = kRows>
__device__ __forceinline__ Step next_step(const int* prefix, int q, int t,
                                          int hi) {
  while (t < kTaps && prefix[t + 1] <= q) ++t;
  if (q >= hi || t >= kTaps) return Step{t, q, 0};
  return Step{t, q, min(R, min(hi, prefix[t + 1]) - q)};
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

// K10-bf16's products: pass 3 with bfloat16 operands on the tensor cores.
// X and d_out are rounded to bfloat16 once a call, before the products,
// by the count pass's grid (count_bf16_kernel; the rounding is elementwise,
// so it gives the bits of JAX's astype after the gather). A step is up to 64
// consecutive pairs of one tap, the K dimension of dW[t] += X^T . d_out
// ([Cin x Cout], mma.sync.m16n8k16, bf16 -> f32). Its X and d_out rows
// are copied as they lie, [pair][channel], with 16-byte (a width of 4:
// 8-byte) cp.async into a ring of three shared-memory stages, two steps
// ahead of the products, one barrier a step, and the fragments come from
// ldmatrix.trans (the pair index is k in both operands). Each step's pairs
// (input row, output row) are copied into shared memory two steps before
// its rows, so no copy waits on a load from the pair list. The pairs past a
// step's last up to a multiple of 16 are zeroed rows, the channels past
// Cin and Cout up to multiples of 16 zero from the start. Warps own 16 x
// 16 tiles of dW (two accumulators of 16 x 8); where there are fewer
// tiles than the 8 warps, groups of warps take every G-th k step and are
// summed in group order. The blocks' shares and partial slots are
// products_kernel's, so pass 4 sums them in the same fixed order. What
// bounds it (measured on the H100, by clock64 per phase of a block and by
// switching parts off): issuing each step's copies, which waited on the
// pairs loaded one step before until the pairs were staged too; 64-pair
// steps ran faster than 128, and twice the blocks slower. The first design
// (PR 20) staged 64 pairs a step as float32 in registers, rounded them and
// stored them transposed, 2 bytes a store.
constexpr int kB16Rows = 64;              // pairs a step
constexpr int kB16Ring = 3;               // steps in shared memory
constexpr int kB16IdxSlots = 4;           // steps' pairs in shared memory
constexpr int kB16RedFloats = 2048;       // group partial sums (G > 1)
// a thread's copies of a step: 64 rows of X and of d_out, each up to 16
// 8-byte pieces (a width that is not a multiple of 8)
constexpr int kB16Pieces = kB16Rows * 2 * 16 / kThreads;

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

__host__ __device__ inline int pad16(int c) { return (c + 15) & ~15; }

// a stage's bytes: kB16Rows rows of X and of d_out, each padded by 8
// bfloat16 (the pad spreads ldmatrix's rows over the banks)
int stage_bytes_bf16(int cin, int cout) {
  return kB16Rows * (pad16(cin) + 8 + pad16(cout) + 8) * 2;
}

// tap_prefix by one warp's scan (lane t loads totals[t]): the same
// integers, without thread 0's 27 loads in a row
__device__ void tap_prefix_scan(const int* __restrict__ totals,
                                int* prefix) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int v = lane < kTaps ? totals[lane] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < kTaps) prefix[lane] = x - v;
    if (lane == kTaps - 1) prefix[kTaps] = x;
  }
  __syncthreads();
}

// K10-bf16's pass 1: count_kernel's counts, and X and d_out rounded to
// bfloat16 copies by the same grid, grid-stride, 4 values a thread (both
// widths are multiples of 4)
template <typename IdxT>
__global__ void __launch_bounds__(kScan)
count_bf16_kernel(const IdxT* __restrict__ plan, int m_out, int m_chunks,
                  int* __restrict__ counts, const float4* __restrict__ a,
                  long long na, const float4* __restrict__ b, long long nb,
                  __nv_bfloat162* __restrict__ a16,
                  __nv_bfloat162* __restrict__ b16) {
  int g;
  const bool found = plan_entry(plan, blockIdx.y, m_out, m_chunks, &g) >= 0;
  const int n = __syncthreads_count(found);
  if (threadIdx.x == 0) counts[blockIdx.y * gridDim.x + blockIdx.x] = n;
  const long long step =
      static_cast<long long>(gridDim.x) * gridDim.y * kScan;
  for (long long i =
           (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
               kScan + threadIdx.x;
       i < na + nb; i += step) {
    const bool in_a = i < na;
    const long long j = in_a ? i : i - na;
    const float4 v = in_a ? a[j] : b[j];
    __nv_bfloat162* d = (in_a ? a16 : b16) + 2 * j;
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
products_bf16_kernel(const __nv_bfloat16* __restrict__ feats, int cin,
                     const __nv_bfloat16* __restrict__ d_out, int cout,
                     const int2* __restrict__ pairs, int rows,
                     const int* __restrict__ totals, int stage_bytes,
                     float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* red = reinterpret_cast<float*>(smem + kB16Ring * stage_bytes);
  __shared__ int prefix[kTaps + 1];
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  tap_prefix_scan(totals, prefix);
  const int total = prefix[kTaps];
  const int lo = share_start(total, blk, gridDim.x);
  const int hi = share_start(total, blk + 1, gridDim.x);
  const int cpad = pad16(cin);
  const int opad = pad16(cout);
  const int ldx = cpad + 8;                 // bfloat16 a staged X row
  const int ldd = opad + 8;                 // and d_out row
  const int nb = opad / 16;
  const int tiles = (cpad / 16) * nb;       // 16 x 16 tiles of dW
  constexpr int kWarps = kThreads / 32;
  // warps of group grp take tiles tile0 .. tile1 - 1 and the k steps
  // ks with ks % groups == grp
  const int groups = tiles >= kWarps ? 1 : kWarps / tiles;
  const int per = tiles >= kWarps ? (tiles + kWarps - 1) / kWarps : 1;
  const int grp = tiles >= kWarps ? 0 : warp / tiles;
  const int tile0 = tiles >= kWarps ? warp * per : warp % tiles;
  const int tile1 = grp < groups ? min(tiles, tile0 + per) : tile0;
  // copies: 16 bytes (8 channels) where the width allows, else 8 bytes
  const bool xw = (cin & 7) == 0;
  const bool dwide = (cout & 7) == 0;
  const int px = xw ? cin >> 3 : cin >> 2;     // pieces a row
  const int pd = dwide ? cout >> 3 : cout >> 2;
  const int n_pieces = kB16Rows * (px + pd);

  // step s's pairs in index slot s % 4 (int2: input row, output row)
  int2* sidx = reinterpret_cast<int2*>(red + kB16RedFloats);
  auto fetch_idx = [&](int s, const Step& st) {
    const int2* pt = pairs + static_cast<long long>(st.t) * rows +
                     (st.q - prefix[st.t]);
    if (tid < st.n) cp_async8(sidx + (s % kB16IdxSlots) * kB16Rows + tid,
                              pt + tid);
  };
  // step s's X and d_out rows into stage s % 3: a thread's pieces i = tid
  // + k * 256, X (pair r, piece q) for i < 64 px, then d_out, their rows
  // read from the step's index slot
  auto issue = [&](int s, const Step& st) {
    unsigned char* base = smem + (s % kB16Ring) * stage_bytes;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* ds = xs + kB16Rows * ldx;
    const int2* si = sidx + (s % kB16IdxSlots) * kB16Rows;
#pragma unroll
    for (int k = 0; k < kB16Pieces; ++k) {
      const int i = tid + k * kThreads;
      if (i < kB16Rows * px) {
        const int r = i / px;
        const int q = i - r * px;
        if (r >= st.n) continue;
        const long long row = si[r].x;
        if (xw) {
          cp_async16(xs + r * ldx + 8 * q, feats + row * cin + 8 * q);
        } else {
          cp_async8(xs + r * ldx + 4 * q, feats + row * cin + 4 * q);
        }
      } else if (i < n_pieces) {
        const int e = i - kB16Rows * px;
        const int r = e / pd;
        const int q = e - r * pd;
        if (r >= st.n) continue;
        const long long row = si[r].y;
        if (dwide) {
          cp_async16(ds + r * ldd + 8 * q, d_out + row * cout + 8 * q);
        } else {
          cp_async8(ds + r * ldd + 4 * q, d_out + row * cout + 4 * q);
        }
      }
    }
    // the rows past the step's last pair up to a multiple of 16: zero
    // (both operands: an unwritten row may hold any bits)
    const int n16 = (st.n + 15) & ~15;
    const int wx = cpad / 8, wd = opad / 8;      // 16-byte words a row
    for (int i = tid; i < (n16 - st.n) * (wx + wd); i += kThreads) {
      const int r = st.n + i / (wx + wd);
      const int w = i % (wx + wd);
      uint4* d = w < wx
          ? reinterpret_cast<uint4*>(xs + r * ldx) + w
          : reinterpret_cast<uint4*>(ds + r * ldd) + (w - wx);
      *d = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // the padding channels of both stages, zero once
  {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const int nx = cpad - cin, nd = opad - cout;
    for (int i = tid; i < kB16Ring * kB16Rows * (nx + nd); i += kThreads) {
      const int h = i / (kB16Rows * (nx + nd));
      const int e = i - h * kB16Rows * (nx + nd);
      const int r = e / (nx + nd);
      const int c = e - r * (nx + nd);
      __nv_bfloat16* xs =
          reinterpret_cast<__nv_bfloat16*>(smem + h * stage_bytes);
      if (c < nx) {
        xs[r * ldx + cin + c] = zero;
      } else {
        xs[kB16Rows * ldx + r * ldd + cout + (c - nx)] = zero;
      }
    }
  }

  float acc[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[u][h][0] = acc[u][h][1] = acc[u][h][2] = acc[u][h][3] = 0.0f;
    }
  }
  // ldmatrix.x4.trans lanes: matrix mi = lane / 8, its row lane % 8. X^T's
  // A tile (k0, ci0): pair k0 + lane % 8 + 8 (mi / 2), channel ci0 +
  // 8 (mi % 2); d_out's two B tiles (k0, co0): pair k0 + lane % 8 +
  // 8 (mi % 2), channel co0 + 8 (mi / 2)
  const int mi = lane >> 3;
  const int a_off = ((lane & 7) + 8 * (mi >> 1)) * ldx + 8 * (mi & 1);
  const int b_off = ((lane & 7) + 8 * (mi & 1)) * ldd + 8 * (mi >> 1);
  // steps j + 1 and j + 2 copy while step j multiplies, and the pairs of
  // steps j + 3 and j + 4 with them; a commit group g holds step g's rows
  // and step g + 2's pairs (a step of no pairs copies nothing: its empty
  // group keeps the waits' count)
  Step cur = next_step<kB16Rows>(prefix, lo, 0, hi);
  Step nxt = next_step<kB16Rows>(prefix, cur.q + cur.n, cur.t, hi);
  Step nx2 = next_step<kB16Rows>(prefix, nxt.q + nxt.n, nxt.t, hi);
  Step nx3 = next_step<kB16Rows>(prefix, nx2.q + nx2.n, nx2.t, hi);
  Step nx4 = next_step<kB16Rows>(prefix, nx3.q + nx3.n, nx3.t, hi);
  for (int i = tid; i < 2 * kB16Rows; i += kThreads) {
    const Step& st = i < kB16Rows ? cur : nxt;
    const int r = i % kB16Rows;
    if (r < st.n) {
      sidx[i] = pairs[static_cast<long long>(st.t) * rows +
                      (st.q - prefix[st.t]) + r];
    }
  }
  __syncthreads();
  issue(0, cur);
  fetch_idx(2, nx2);
  cp_async_commit();
  issue(1, nxt);
  fetch_idx(3, nx3);
  cp_async_commit();
  for (int j = 0; cur.n > 0; ++j) {
    cp_async_wait<kB16Ring - 2>();
    __syncthreads();      // step j arrived; every warp is done with j - 1
    issue(j + 2, nx2);    // into j - 1's stage
    fetch_idx(j + 4, nx4);
    cp_async_commit();
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + (j % kB16Ring) * stage_bytes);
    const __nv_bfloat16* ds = xs + kB16Rows * ldx;
    const int nks = (cur.n + 15) >> 4;
    for (int ks = grp; ks < nks && tile0 < tile1; ks += groups) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tile = tile0 + u;
        if (u >= per || tile >= tile1) break;
        unsigned a[4], bq[4];
        ldmatrix_x4_trans(a, xs + 16 * ks * ldx + a_off + 16 * (tile / nb));
        ldmatrix_x4_trans(bq, ds + 16 * ks * ldd + b_off + 16 * (tile % nb));
        mma_bf16(acc[u][0], a, bq);
        mma_bf16(acc[u][1], a, bq + 2);
      }
    }
    if (nxt.n == 0 || nxt.t != cur.t) {
      // the block's last step of tap cur.t: its sums go to partial slot
      // blk + cur.t (see products_kernel), the groups' added in order
      float* dst = partial + static_cast<long long>(blk + cur.t) * cin * cout;
      if (groups == 1) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int tile = tile0 + u;
          if (u < per && tile < tile1) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = (tile / nb) * 16 + g + (e >> 1) * 8;
                const int o = (tile % nb) * 16 + h * 8 + 2 * tig + (e & 1);
                if (c < cin && o < cout) dst[c * cout + o] = acc[u][h][e];
                acc[u][h][e] = 0.0f;
              }
            }
          }
        }
      } else {
        if (tile0 < tile1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = (tile0 / nb) * 16 + g + (e >> 1) * 8;
              const int o = (tile0 % nb) * 16 + h * 8 + 2 * tig + (e & 1);
              red[(grp * cpad + c) * opad + o] = acc[0][h][e];
              acc[0][h][e] = 0.0f;
            }
          }
        }
        __syncthreads();
        for (int e = tid; e < cin * cout; e += kThreads) {
          const int c = e / cout;
          const int o = e - c * cout;
          float sum = red[c * opad + o];
          for (int q = 1; q < groups; ++q) {
            sum += red[(q * cpad + c) * opad + o];
          }
          dst[e] = sum;
        }
      }
    }
    cur = nxt;
    nxt = nx2;
    nx2 = nx3;
    nx3 = nx4;
    nx4 = next_step<kB16Rows>(prefix, nx4.q + nx4.n, nx4.t, hi);
  }
}

// operands: null for K10; for K10-bf16 the bfloat16 copies of feats and
// d_out (16-byte aligned), made by count_bf16_kernel
template <typename IdxT>
int launch(const float* feats, int m_in, int cin, const IdxT* plan,
           int batch, int m_out, const float* d_out, int cout, int blocks,
           int* counts, int2* pairs, int* totals, float* partial, float* dw,
           void* operands, cudaStream_t s) {
  const bool bf16 = operands != nullptr;
  __nv_bfloat16* x16 = static_cast<__nv_bfloat16*>(operands);
  const long long nx = static_cast<long long>(batch) * m_in * cin;
  __nv_bfloat16* d16 = x16 + (nx + 7) / 8 * 8;
  const int m_chunks = (m_out + kScan - 1) / kScan;
  const dim3 scan_grid(batch * m_chunks, kTaps);
  if (bf16) {
    count_bf16_kernel<IdxT><<<scan_grid, kScan, 0, s>>>(
        plan, m_out, m_chunks, counts, reinterpret_cast<const float4*>(feats),
        nx / 4, reinterpret_cast<const float4*>(d_out),
        static_cast<long long>(batch) * m_out * cout / 4,
        reinterpret_cast<__nv_bfloat162*>(x16),
        reinterpret_cast<__nv_bfloat162*>(d16));
  } else {
    count_kernel<IdxT><<<scan_grid, kScan, 0, s>>>(plan, m_out, m_chunks,
                                                   counts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<IdxT><<<scan_grid, kScan, 0, s>>>(
      plan, m_in, m_out, m_chunks, batch * m_out, counts, pairs, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bf16) {
    static bool done[64] = {};
    if (!done[dev]) {
      err = cudaFuncSetAttribute(
          products_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kB16Ring * stage_bytes_bf16(kMaxC, kMaxC) + kB16RedFloats * 4 +
              kB16IdxSlots * kB16Rows * 8);
      if (err != cudaSuccess) return static_cast<int>(err);
      done[dev] = true;
    }
    const int stage = stage_bytes_bf16(cin, cout);
    products_bf16_kernel<<<blocks, kThreads,
                           kB16Ring * stage + kB16RedFloats * 4 +
                               kB16IdxSlots * kB16Rows * 8,
                           s>>>(
        x16, cin, d16, cout, pairs, batch * m_out, totals, stage, partial);
  } else {
    const int buf = buffer_floats(cin, cout);
    static bool done[64] = {};
    if (!done[dev]) {
      err = cudaFuncSetAttribute(products_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 2 * buffer_floats(kMaxC, kMaxC) * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      done[dev] = true;
    }
    products_kernel<<<blocks, kThreads, 2 * buf * 4, s>>>(
        feats, cin, d_out, cout, pairs, batch * m_out, totals, buf, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = cin * cout;
  sum_kernel<<<(kTaps * n_out + kSumOuts - 1) / kSumOuts,
               kSumOuts * kSumParts, 0, s>>>(totals, partial, n_out, blocks,
                                             dw);
  return static_cast<int>(cudaGetLastError());
}

int dw_entry(const float* feats, int m_in, int cin, const void* plan,
             int plan_is_i16, int batch, int m_out, const float* d_out,
             int cout, int blocks, int* counts, int* totals, void* pairs,
             float* partial, float* dw, void* operands, void* stream) {
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
                  operands, s);
  }
  return launch(feats, m_in, cin, static_cast<const int*>(plan), batch, m_out,
                d_out, cout, blocks, counts, p2, totals, partial, dw, operands,
                s);
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
  return dw_entry(feats, m_in, cin, plan, plan_is_i16, batch, m_out, d_out,
                  cout, blocks, counts, totals, pairs, partial, dw, nullptr,
                  stream);
}

// K10-bf16: sassd_sparse_conv_dw's arguments and scratch, and operands:
// scratch for X and d_out rounded to bfloat16 (16-byte aligned; batch *
// m_in * cin bfloat16 rounded up to 16 bytes, then batch * m_out * cout),
// the products on the tensor cores (float32 sums).
extern "C" int sassd_sparse_conv_dw_bf16(const float* feats, int m_in,
                                         int cin, const void* plan,
                                         int plan_is_i16, int batch,
                                         int m_out, const float* d_out,
                                         int cout, int blocks, int* counts,
                                         int* totals, void* pairs,
                                         float* partial, float* dw,
                                         void* operands, void* stream) {
  if (operands == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dw_entry(feats, m_in, cin, plan, plan_is_i16, batch, m_out, d_out,
                  cout, blocks, counts, totals, pairs, partial, dw, operands,
                  stream);
}
