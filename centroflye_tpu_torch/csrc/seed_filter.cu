// The fused recruitment step's packed seed filter and pass-order
// compaction, for Hopper (sm_90a), in one launch.
//
// Replaces no TPU kernel: the JAX package's fused step
// (centroflye_tpu/ops/fused_recruit.py, _packed_hits and the argsort of
// _fused_body_packed) computes this in jnp, which XLA fuses on the TPU.
// The port computed it with about 90 small ATen kernels a step, each over
// the whole (B, Lq / 4) plane of 64-bit words, for rows that hold on
// average well under half their words; this kernel gives the same hit
// counts, pass order and bundle, bit for bit.
//
// What it computes, for the B rows of one shard:
//   - hits[r]: the k-mers at in-word phases o = 0, stride, 2 stride, ... < 16
//     of every 16-base word w of packed row r (base 16w + j at bits 2j of
//     the little-endian word), read from the word pair (w, w + 1) in place
//     (the word past the row reads 0), counted where 16w + o + k <= lens[r]
//     and the k-mer's bit is set in the LE-keyed membership bitmap (a word
//     index past the bitmap reads its last word, as the JAX gather clamps);
//   - the bundle [df | dr | hits | n_pass] with df = dr = m (the sentinels
//     that K1c, csrc/myers_hw_chunks.cu, lowers for the rows it scores),
//     n_pass the rows with hits >= min_hits;
//   - top[i], i < K: the first K rows of the stable pass-first order,
//     argsort(hits < min_hits, stable=True)[:K]: the passing rows in row
//     order, then the failing ones.
//
// What bounds it: the bitmap probes. A row of n bases makes about
// n / stride probes, each a 4-byte read at a random word of the bitmap
// (8 MB at k = 13, which stays in the 50 MB L2 between steps), and the
// packed words are read once (n / 4 bytes). At the fused step's 256 rows
// of rel2-like lengths that is about 1.8 M probes: microseconds of L2
// traffic, so a launch is bound by its latency (a row's chain of loads and
// the block's reduction) and by the launch itself.
//
// What the design does about it: one block a row, its threads over the
// row's words, so a row's work stops at its length (a row of length 0
// costs a block that exits) and the 8 probes of a word are independent
// loads in flight together. Each block adds its hits, writes its row of the
// bundle and takes a ticket (atomicInc, which wraps to 0 at B - 1, so the
// ticket is 0 again for the next launch); the block that takes the last
// ticket sees every row's hits and does the compaction: a count of the
// passing rows, then a block-wide prefix of the pass flags (warp ballots)
// over tiles of 256 rows, writing each row's place in the order if it is
// below K. Nothing is read back: K1c reads n_pass and top on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const uint32_t* packed;           // (B, nw): 16 bases a word
  const int32_t* lens;              // (B,)
  const uint32_t* bitmap;           // (bitmap_words,): LE-keyed k-mer bits
  int32_t* out;                     // (3B + 1,): df | dr | hits | n_pass
  int64_t* top;                     // (K,): the pass order's first K rows
  unsigned* ticket;                 // (1,): 0 between launches
  int B, nw, K, m, k, min_hits;
  unsigned bitmap_words;
};

// the sum of v over the block, in every thread; `sums` is the block's
// scratch, free again when this returns
__device__ __forceinline__ int block_sum(unsigned v, unsigned* sums) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += sums[i];
  __syncthreads();
  return static_cast<int>(total);
}

template <int STRIDE>
__global__ void __launch_bounds__(kThreads)
seed_filter_compact(const Args a) {
  __shared__ unsigned sums[kWarps];
  __shared__ bool last;
  if (a.B == 0) {                                 // the bundle is n_pass alone
    if (threadIdx.x == 0) a.out[0] = 0;
    return;
  }

  // the row's hits: a thread a word, every sampled phase of the word
  const int row = blockIdx.x;
  const int len = a.lens[row];
  const uint32_t* words = a.packed + static_cast<size_t>(row) * a.nw;
  const uint32_t kmask = a.k >= 16 ? kFull : (1u << (2 * a.k)) - 1u;
  const int live = len < a.k ? 0 : min(a.nw, (len - a.k) / 16 + 1);
  unsigned count = 0;
  for (int w = threadIdx.x; w < live; w += kThreads) {
    const uint32_t lo = __ldg(words + w);
    const uint32_t hi = w + 1 < a.nw ? __ldg(words + w + 1) : 0u;
    const int room = len - a.k - 16 * w;          // the last phase that fits
#pragma unroll
    for (int o = 0; o < 16; o += STRIDE) {
      if (o <= room) {
        const uint32_t code = __funnelshift_r(lo, hi, 2 * o) & kmask;
        const uint32_t at = min(code >> 5, a.bitmap_words - 1u);
        count += (__ldg(a.bitmap + at) >> (code & 31u)) & 1u;
      }
    }
  }
  const int hits = block_sum(count, sums);
  if (threadIdx.x == 0) {
    a.out[row] = a.m;
    a.out[a.B + row] = a.m;
    a.out[2 * a.B + row] = hits;
    __threadfence();                              // the row before the ticket
    last = atomicInc(a.ticket, a.B - 1) == static_cast<unsigned>(a.B - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last block: every row's hits are in the bundle
  __threadfence();
  const int32_t* all = a.out + 2 * a.B;
  unsigned mine = 0;
  for (int r = threadIdx.x; r < a.B; r += kThreads)
    mine += __ldcg(all + r) >= a.min_hits;
  const int n_pass = block_sum(mine, sums);
  if (threadIdx.x == 0) a.out[3 * a.B] = n_pass;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before_tile = 0;                            // passing rows before it
  for (int r0 = 0; r0 < a.B; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const bool pass = r < a.B && __ldcg(all + r) >= a.min_hits;
    const unsigned ballot = __ballot_sync(kFull, pass);
    if (lane == 0) sums[warp] = __popc(ballot);
    __syncthreads();
    int before = before_tile + __popc(ballot & ((1u << lane) - 1u));
    int tile = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      if (i < warp) before += sums[i];
      tile += sums[i];
    }
    __syncthreads();
    if (r < a.B) {
      const int at = pass ? before : n_pass + (r - before);
      if (at < a.K) a.top[at] = r;
    }
    before_tile += tile;
  }
}

}  // namespace

// packed: (B, 4 nw) uint8 rows, 4-byte aligned; lens: (B,) int32; bitmap:
// (bitmap_words,) 32-bit words of the LE-keyed seed bitmap; out: (3B + 1,)
// int32, written whole; top: (K,) int64, K <= B; ticket: (1,) unsigned,
// 0 before the launch and after it, used by one launch at a time. k: the
// seed length (1..16); stride: 1, 2 or 4; min_hits: the pass threshold in
// sampled positions. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int cf_seed_filter_compact(const void* packed, const void* lens,
                                      const void* bitmap, void* out,
                                      void* top, void* ticket, int B, int nw,
                                      int K, int m, int k, int stride,
                                      int min_hits, int bitmap_words,
                                      void* stream) {
  if (B < 0 || nw < 0 || K < 0 || K > B || k < 1 || k > 16 ||
      bitmap_words < 1 || (stride != 1 && stride != 2 && stride != 4) ||
      nw > (1 << 26))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = B > 0 ? B : 1;
  const Args a{static_cast<const uint32_t*>(packed),
               static_cast<const int32_t*>(lens),
               static_cast<const uint32_t*>(bitmap),
               static_cast<int32_t*>(out), static_cast<int64_t*>(top),
               static_cast<unsigned*>(ticket), B, nw, K, m, k, min_hits,
               static_cast<unsigned>(bitmap_words)};
  if (stride == 1)
    seed_filter_compact<1><<<blocks, kThreads, 0, s>>>(a);
  else if (stride == 2)
    seed_filter_compact<2><<<blocks, kThreads, 0, s>>>(a);
  else
    seed_filter_compact<4><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
