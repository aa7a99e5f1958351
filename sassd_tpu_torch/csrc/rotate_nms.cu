// K2: exact greedy rotated NMS keep flags from K1's IoU matrix.
//
// Replaces: sassd_tpu/core/riou.py rotate_nms + _fixpoint_keep (the TPU
// version iterates a [N, N] masked reduction to the greedy fixpoint).
//
// Input: iou [N, N] float32 over score-sorted boxes, iou[i, j] = IoU with
// box i as K1's subject (a) and box j as the clip box (b); keep0 [N] (valid
// and finite score). Output: keep [N], exact greedy: box c is dropped when
// a kept box r < c has iou[c, r] > thr (strict), the orientation the JAX
// path uses (the later box is the subject).
//
// Bound on the H100: latency. The function reads the upper triangle of the
// matrix, N(N-1)/2 floats (8 MB at N = 2000), a few microseconds; the
// greedy sweep is serial over the N rows. Design:
// - mask: one block of 64 threads per (64-row block rb, 64-column block
//   cb >= rb) packs `iou[c, r] > thr` for c > r into a uint64 word; threads
//   on consecutive rows read consecutive addresses, all 64 loads of a
//   thread in flight together. Blocks cb < rb, which the sweep never reads,
//   exit at once, so only the upper triangle is read. The bitmask is packed
//   by row block: block w holds its 64 rows' words w .. ceil(N/64) - 1,
//   contiguous. The diagonal blocks also pack keep0 into one candidate word
//   per row block.
// - sweep: one warp. Lane l holds the "removed" words l, l + 32, ... in
//   registers, a box that is no candidate counting as removed from the
//   start. Row block w is staged into shared memory by one bulk copy (the
//   TMA unit, an mbarrier counting its bytes), double-buffered: block w + 1
//   is in flight while block w resolves. Block w's decisions read only its
//   diagonal words and the removed word w (a shuffle); every lane makes
//   them, with no barrier and no global load on the way. The lowest alive
//   row is kept and removes the rows its diagonal word names, one kept row
//   at a time (a dependent shared load each) for up to kSurvivorSteps kept
//   rows; a block with more kept rows finishes with a fixed 64-step chain
//   in registers. Each lane then ORs the kept rows' words of its own
//   columns into its registers, one kept row at a time when they are few,
//   else all 64 rows masked by their kept bits (independent loads that
//   overlap). The cost a block so follows its kept rows: at the NMS path's
//   threshold 0.1 a block keeps a few. One __syncwarp a block orders the
//   staging buffers; there is no __syncthreads.
// N is at most 32 * 64 * kMaxWordsPerLane = 8192 (the wrapper raises
// above that); the NMS path runs N = min(nms_pre, guided_test) <= 2048, one
// word a lane.
// The mask kernel reads K1's matrix rather than evaluating the overlap for
// c > r itself, as the JAX path computes the matrix and then the fixpoint.
// The keep flags are then a function of the matrix alone, so they can be
// held bit for bit against the plain greedy on the same matrix; a fused
// mask kernel would save half of K1's pairs and the 16 MB round trip,
// roughly 0.07 ms of an H100's time at N = 2000.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWordsPerLane = 4;
constexpr unsigned kFull = 0xffffffffu;
// a block resolves its first rows one kept row at a time (a dependent
// shared load each); past this many kept rows it runs the fixed 64-step
// chain over the block
constexpr int kSurvivorSteps = 8;
// the kept rows' words are ORed one kept row at a time up to this many,
// else all 64 rows masked by their kept bits
constexpr int kKeptLoopRows = 12;

// Word offset of row block w in the packed bitmask: block v holds its 64
// rows' words v .. col_blocks - 1, [64][col_blocks - v].
__device__ __forceinline__ long long block_offset(int w, int col_blocks) {
  return 64ll * (static_cast<long long>(w) * col_blocks -
                 static_cast<long long>(w) * (w - 1) / 2);
}

__global__ void __launch_bounds__(64)
nms_mask_kernel(const float* __restrict__ iou,
                const unsigned char* __restrict__ keep0, int n, float thr,
                unsigned long long* __restrict__ mask,
                unsigned* __restrict__ cand) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int col_blocks = gridDim.x;
  if (cb < rb) return;                                  // uniform
  const int r = rb * 64 + threadIdx.x;
  if (cb == rb) {
    const unsigned bits = __ballot_sync(kFull, r < n && keep0[r] != 0);
    if ((threadIdx.x & 31) == 0) cand[2 * rb + (threadIdx.x >> 5)] = bits;
  }
  unsigned long long bits = 0ull;
  if (r < n) {
    // all 64 loads first, unconditional (clamped to the last column), so
    // they are in flight together
    const float* col = iou + r;                         // iou[c, r]
    const int c0 = cb * 64;
    float v[64];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      v[t] = col[static_cast<long long>(min(c0 + t, n - 1)) * n];
    }
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      const int c = c0 + t;
      if (c > r && c < n && v[t] > thr) bits |= 1ull << t;
    }
  }
  mask[block_offset(rb, col_blocks) + threadIdx.x * (col_blocks - rb) +
       (cb - rb)] = bits;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage `bytes` from global memory into shared memory with one bulk copy
// (the Hopper TMA unit), completion counted on `bar`. One thread calls it.
__device__ __forceinline__ void bulk_stage(void* dst, const void* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  // the warp's earlier reads of dst are ordered before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_stage(unsigned long long* bar,
                                           unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Lowest set row of the 64-bit set (lo: rows 0-31, hi: rows 32-63), which
// must not be empty.
__device__ __forceinline__ int lowest_row(unsigned lo, unsigned hi) {
  return lo != 0u ? __ffs(lo) - 1 : 31 + __ffs(hi);
}

// Resolve row block w: `lo`/`hi` enter as the removed rows (removed word w)
// and leave as the rows removed by the greedy; the kept rows are the rest.
// buf holds the block's rows, len words each, the diagonal word first.
__device__ __forceinline__ void resolve_block(
    const unsigned long long* buf, int len, unsigned& lo, unsigned& hi) {
  // one kept row at a time: the lowest alive row is kept and removes the
  // rows its diagonal word names (rows above its own)
  unsigned alo = ~lo, ahi = ~hi;                        // alive rows
  for (int step = 0; step < kSurvivorSteps && (alo | ahi) != 0u; ++step) {
    const int i = lowest_row(alo, ahi);
    const unsigned long long d = buf[i * len];
    if (i < 32) {
      alo &= ~(1u << i);
    } else {
      ahi &= ~(1u << (i - 32));
    }
    lo |= static_cast<unsigned>(d);
    hi |= static_cast<unsigned>(d >> 32);
    alo &= ~static_cast<unsigned>(d);
    ahi &= ~static_cast<unsigned>(d >> 32);
  }
  if ((alo | ahi) == 0u) return;
  // more kept rows: the fixed chain over all 64 rows, in registers, from
  // this state (the rows already kept OR their words again, which changes
  // nothing). The diagonal words are loaded first, so no load is on the
  // chain; rows 32-63 touch the high half only.
  const unsigned* buf32 = reinterpret_cast<const unsigned*>(buf);
  unsigned dlo[32], dhi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i < 32) {
      const unsigned long long d = buf[i * len];
      dlo[i] = static_cast<unsigned>(d);
      dhi[i] = static_cast<unsigned>(d >> 32);
    } else {
      dhi[i] = buf32[2 * i * len + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!(lo & (1u << i))) {
      lo |= dlo[i];
      hi |= dhi[i];
    }
  }
#pragma unroll
  for (int i = 32; i < 64; ++i) {
    if (!(hi & (1u << (i - 32)))) hi |= dhi[i];
  }
}

// OR of word `col` of the kept rows (klo: rows 0-31, khi: rows 32-63).
__device__ __forceinline__ unsigned long long kept_words(
    const unsigned long long* buf, int len, int col, unsigned klo,
    unsigned khi) {
  if (__popc(klo) + __popc(khi) <= kKeptLoopRows) {     // uniform
    unsigned long long acc = 0ull;
    while ((klo | khi) != 0u) {
      const int i = lowest_row(klo, khi);
      if (klo != 0u) {
        klo &= klo - 1u;
      } else {
        khi &= khi - 1u;
      }
      acc |= buf[i * len + col];
    }
    return acc;
  }
  // every row's word loaded and masked by its kept bit: no load waits on a
  // branch, so they overlap
  unsigned alo[2] = {0u, 0u}, ahi[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const unsigned m = static_cast<unsigned>(
        static_cast<int>((i < 32 ? klo : khi) << (31 - (i & 31))) >> 31);
    const unsigned long long x = buf[i * len + col];
    alo[i & 1] |= static_cast<unsigned>(x) & m;
    ahi[i & 1] |= static_cast<unsigned>(x >> 32) & m;
  }
  return (static_cast<unsigned long long>(ahi[0] | ahi[1]) << 32) |
         (alo[0] | alo[1]);
}

template <int WPL>
__global__ void __launch_bounds__(32)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const unsigned long long* __restrict__ cand, int n,
                 int col_blocks, unsigned char* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned long long stage[];  // [2][64 * col_blocks]
  __shared__ __align__(8) unsigned long long bar[2];
  const int lane = threadIdx.x;
  const long long buf_words = 64ll * col_blocks;
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_stage(stage, mask, 64u * col_blocks * 8u, &bar[0]);
  }
  __syncwarp();
  unsigned long long removed[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int c = k * 32 + lane;
    removed[k] = c < col_blocks ? ~cand[c] : ~0ull;
  }
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    for (int wl = 0; wl < 32; ++wl) {
      const int w = j * 32 + wl;
      if (w >= col_blocks) break;                       // uniform
      if (lane == 0 && w + 1 < col_blocks) {
        bulk_stage(stage + ((w + 1) & 1) * buf_words,
                   mask + block_offset(w + 1, col_blocks),
                   64u * (col_blocks - w - 1) * 8u, &bar[(w + 1) & 1]);
      }
      wait_stage(&bar[w & 1], (w >> 1) & 1);            // block w is in
      const unsigned long long* buf = stage + (w & 1) * buf_words;
      const int len = col_blocks - w;

      const unsigned long long rem = __shfl_sync(kFull, removed[j], wl);
      unsigned lo = static_cast<unsigned>(rem);
      unsigned hi = static_cast<unsigned>(rem >> 32);
      resolve_block(buf, len, lo, hi);
      const unsigned klo = ~lo;                         // kept rows 0-31
      const unsigned khi = ~hi;                         // kept rows 32-63
      const int r0 = w * 64;
      if (r0 + lane < n) keep[r0 + lane] = (klo >> lane) & 1u;
      if (r0 + 32 + lane < n) keep[r0 + 32 + lane] = (khi >> lane) & 1u;

      // the kept rows remove, in this lane's words past block w
      if ((klo | khi) != 0u) {
#pragma unroll
        for (int k = j; k < WPL; ++k) {
          const int c = k * 32 + lane;
          if (c > w && c < col_blocks) {
            removed[k] |= kept_words(buf, len, c - w, klo, khi);
          }
        }
      }
      __syncwarp();                 // buf is read before it is staged again
    }
  }
}

template <int WPL>
int launch(const float* iou, const unsigned char* keep0, int n, float thr,
           unsigned long long* scratch, unsigned char* keep, cudaStream_t s) {
  const int col_blocks = (n + 63) / 64;
  unsigned long long* mask = scratch;
  unsigned long long* cand =
      scratch + 32ll * col_blocks * (col_blocks + 1);
  nms_mask_kernel<<<dim3(col_blocks, col_blocks), 64, 0, s>>>(
      iou, keep0, n, thr, mask, reinterpret_cast<unsigned*>(cand));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // two row blocks of 64 * col_blocks words: 32 KB at N = 2048, above the
  // default 48 KB from N = 3073
  const int smem = 2 * 64 * col_blocks * static_cast<int>(sizeof(*mask));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel<WPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<WPL><<<1, 32, smem, s>>>(mask, cand, n, col_blocks, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: caller-allocated 32 * b * (b + 1) + b uint64, b = ceil(n/64) (the
// packed bitmask, then the candidate words); n <= 8192.
extern "C" int sassd_nms_keep(const float* iou, const unsigned char* keep0,
                              int n, float thr, unsigned long long* scratch,
                              unsigned char* keep, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int col_blocks = (n + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (col_blocks <= 32) return launch<1>(iou, keep0, n, thr, scratch, keep, s);
  if (col_blocks <= 64) return launch<2>(iou, keep0, n, thr, scratch, keep, s);
  if (col_blocks <= 32 * kMaxWordsPerLane) {
    return launch<4>(iou, keep0, n, thr, scratch, keep, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
