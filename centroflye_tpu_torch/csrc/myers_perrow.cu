// Per-row-query Myers edit distance for Hopper (sm_90a): kernel K4.
//
// The card's counterpart of the JAX package's ops/myers.py:113
// myers_distance_batch with per-row queries (a jnp scan there, no Pallas
// kernel), as the monomer decomposer (mono/string_decomposer.py) calls it:
// every text window r of R against every query q of Q, row b = r * Q + q.
// For row b, with m_q = ms[q] and the query's (5, W) peq table:
//   - state: vp all ones, vn 0, score = best = m_q, end = -1;
//   - Eq = peq[c] for a code c in 0..3, peq[4] for any other code (build_peq
//     leaves row 4 zero: N and PAD match nothing);
//   - SHW shifts a 1 into hp's bit 0 (the top row's +1 a column), HW a 0
//     (free start in the text);
//   - inc = bit (m_q - 1) of hp minus the same bit of hn, before the shift:
//     the score is tracked at the row's own last query row; peq bits at and
//     above m_q are zero;
//   - only columns j < tlens[r] (and < L) move the state; `best` takes the
//     first column whose score is strictly below it, so end is -1 when the
//     empty alignment (score m_q) is never beaten.
// Two collections (ops/myers_cuda.myers_perrow admits the decomposer's two
// calls, SHW/call and HW/all):
//   - call: the window's call, chosen on the card. Of the window's Q rows,
//     the query with the least best / m_q, the first on ties, compared by
//     cross-multiplying (d_a m_b < d_b m_a), which is exact; with d, m <=
//     256 two distinct quotients differ by at least 1/65,536 and two equal
//     ones round to the same double, so it is the host's
//     np.argmin(dist / ms). Out: (q, dist, end) a window, 12 bytes, in
//     place of 8 Q bytes of every row's (dist, end);
//   - all: the score after every one of the L columns (masked columns
//     repeat it), (R Q, L).
//
// Bound. 11 INT32 operations per query word per column (d0 = ((Eq & vp) +
// vp ^ vp) | Eq | vn, hp, hn, their two shifts, vp and vn), over the card's
// 64 INT32 lanes per SM and clock; each code, table and output byte moves
// once, far below the operations' time. At the decomposer's full batch
// (about 1,000 windows x 36 queries = 36k rows, 237 columns, W = 6) that is
// about 34 us: 36k threads fill the 132 SMs, so the card is
// throughput-bound there, not latency-bound as one thread's chain of 237
// column steps was when a step held 32 windows.
//
// What the design does about it:
//   - whole windows per block: a block is k windows times their Q
//     queries, one thread a row, so that one launch of the whole lockstep
//     batch fills every SM and the call can be chosen inside the block.
//     k is at most 256 / Q (7 x 36 = 252 threads), and fewer where that
//     spreads the windows more evenly over the SMs: 1,024 windows in
//     blocks of 7 leave 15 SMs two blocks and the rest one, in blocks of
//     4 no SM holds more than 8 windows (`windows_per_block`);
//   - staging: the block stages its windows' codes once into shared
//     memory (mapped to 0..4), in tiles of at most 16 KB and within the
//     48 KB a block may hold without opting in, so a column's code is a
//     shared-memory broadcast among the window's Q threads and no global
//     load sits in the column chain. The Q query tables (4.3 KB at the
//     decomposer's 36) sit in shared memory too, one load a word at a
//     per-column base, the row stride odd so that neighbouring queries
//     fall in different banks; this was faster than each thread keeping
//     its own table in registers at both of the decomposer's step shapes
//     (PERF.md). The next column's Eq words are fetched before the
//     current column is scored;
//   - the add's carry runs through the words as one add.cc / addc chain
//     (one instruction a word), the shifted hp and hn as funnel shifts;
//   - the call in an epilogue: each row leaves (best, end) in shared
//     memory and one thread a window scans its Q rows, so a step writes
//     and reads back 12 bytes a window instead of every row.
// The `all` collection, once a decomposer batch, keeps the same block
// layout and writes each row's scores as it goes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 256;     // k = 256 / Q whole windows a block
constexpr int kMaxWords = 8;        // m <= 256
constexpr int kCodes = 5;
constexpr int kTileBytes = 16384;   // staged codes a block holds at once
// dynamic shared memory a block may take without opting in (48 KB, less
// the static n_max)
constexpr int kSmemBytes = 48 * 1024 - 16;

enum Mode { kHW = 0, kSHW = 1 };

struct Args {
  const uint32_t* peqs;             // (Q, 5, W) 32-bit words
  const int32_t* ms;                // (Q,) query lengths, 1 <= ms <= 32 W
  const int8_t* texts;              // (R, L) codes
  const int32_t* tlens;             // (R,)
  int32_t* call;                    // (3, R): q, dist, end; collect call
  int32_t* scores;                  // (R Q, L), collect all
  int Q, R, L, mode;
  int per_block;                    // k windows a block
  int tile;                         // text columns staged at a time
};

// the row stride of a query's table in shared memory: odd, so that the
// same word of neighbouring queries lies in different banks
__host__ __device__ constexpr int table_stride(int W) {
  return (kCodes * W) | 1;
}

// shared memory a block holds besides its staged codes: the query
// lengths and tables, and each row's (best, end) for the call
inline int table_bytes(int Q, int k, int W, bool all) {
  return static_cast<int>(sizeof(int32_t)) *
         (Q + (all ? 0 : 2 * k * Q) + Q * table_stride(W));
}

// s = x + y over W little-endian words: one carry chain
template <int W>
__device__ __forceinline__ void add_words(uint32_t (&s)[W],
                                          const uint32_t (&x)[W],
                                          const uint32_t (&y)[W]) {
  if constexpr (W == 1) {
    s[0] = x[0] + y[0];
  } else {
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s[0]) : "r"(x[0]), "r"(y[0]));
#pragma unroll
    for (int i = 1; i < W - 1; ++i)
      asm volatile("addc.cc.u32 %0, %1, %2;"
                   : "=r"(s[i]) : "r"(x[i]), "r"(y[i]));
    asm volatile("addc.u32 %0, %1, %2;"
                 : "=r"(s[W - 1]) : "r"(x[W - 1]), "r"(y[W - 1]));
  }
}

// the Eq words of code c (0..4) from the query's table in shared memory
template <int W>
__device__ __forceinline__ void fetch_eq(uint32_t (&e)[W], int c,
                                         const uint32_t* table) {
  const uint32_t* t = table + c * W;
#pragma unroll
  for (int i = 0; i < W; ++i) e[i] = t[i];
}

template <int W, bool kAll>
__global__ void __launch_bounds__(kBlockRows)
myers_perrow_kernel(const Args a) {
  extern __shared__ int4 smem[];
  __shared__ int n_max;
  const int Q = a.Q, k = a.per_block, L = a.L, tile = a.tile;
  const int rows = k * Q;                       // == blockDim.x
  int32_t* ms_s = reinterpret_cast<int32_t*>(smem);
  int32_t* dist_s = ms_s + Q;
  int32_t* end_s = dist_s + (kAll ? 0 : rows);
  uint32_t* peq_s = reinterpret_cast<uint32_t*>(end_s + (kAll ? 0 : rows));
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(peq_s + Q * table_stride(W));

  const int tid = threadIdx.x;
  const int w = tid / Q, q = tid - w * Q;
  const int r0 = blockIdx.x * k;
  const int nw = min(k, a.R - r0);              // windows of this block
  const int r = r0 + w;
  const bool live = w < nw;

  for (int i = tid; i < Q; i += rows) ms_s[i] = a.ms[i];
  for (int i = tid; i < Q * kCodes * W; i += rows) {
    const int qq = i / (kCodes * W);
    peq_s[qq * table_stride(W) + (i - qq * kCodes * W)] = a.peqs[i];
  }
  if (tid == 0) n_max = 0;
  __syncthreads();
  const int n = live ? max(0, min(a.tlens[r], L)) : 0;
  if (live && q == 0 && n > 0) atomicMax(&n_max, n);
  __syncthreads();
  const int span = kAll ? L : n_max;            // columns the block walks

  const int mq = live ? ms_s[q] : 1;
  const int tap_word = (mq - 1) >> 5;
  const int tap_bit = (mq - 1) & 31;
  const uint32_t top = a.mode == kHW ? 0u : 0x80000000u;
  const uint32_t* my_table = peq_s + q * table_stride(W);
  const uint8_t* my_codes = codes_s + w * tile;
  int32_t* out = kAll && live
                     ? a.scores + (static_cast<size_t>(r) * Q + q) * L
                     : nullptr;

  uint32_t vp[W], vn[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    vp[i] = 0xFFFFFFFFu;
    vn[i] = 0u;
  }
  int score = mq, best = mq, best_j = -1;
  for (int j0 = 0; j0 < span; j0 += tile) {
    const int tw = min(tile, span - j0);
    __syncthreads();                            // the last tile is read
    for (int i = tid; i < nw * tw; i += rows) {
      const int ww = i / tw, jj = i - ww * tw;
      const int t = a.texts[static_cast<size_t>(r0 + ww) * L + j0 + jj];
      codes_s[ww * tile + jj] = static_cast<uint8_t>(t >= 0 && t < 4 ? t : 4);
    }
    __syncthreads();
    const int cols = min(n - j0, tw);           // this row's, may be <= 0
    if (cols <= 0) continue;
    uint32_t eq[W];
    fetch_eq<W>(eq, my_codes[0], my_table);
    for (int jj = 0; jj < cols; ++jj) {
      uint32_t e[W], x[W], s[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        e[i] = eq[i];
        x[i] = e[i] & vp[i];
      }
      if (jj + 1 < cols)
        fetch_eq<W>(eq, my_codes[jj + 1], my_table);
      add_words<W>(s, x, vp);
      uint32_t hp_lo = top, hn_lo = 0u, tap_p = 0u, tap_n = 0u;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t d0 = (s[i] ^ vp[i]) | e[i] | vn[i];
        const uint32_t hp = vn[i] | ~(d0 | vp[i]);
        const uint32_t hn = vp[i] & d0;
        if (i == tap_word) {
          tap_p = hp;
          tap_n = hn;
        }
        // (hp << 1) with the word below's top bit (or the top row's) in
        const uint32_t hps = __funnelshift_l(hp_lo, hp, 1);
        const uint32_t hns = __funnelshift_l(hn_lo, hn, 1);
        hp_lo = hp;
        hn_lo = hn;
        vp[i] = hns | ~(d0 | hps);
        vn[i] = hps & d0;
      }
      score += static_cast<int>((tap_p >> tap_bit) & 1u) -
               static_cast<int>((tap_n >> tap_bit) & 1u);
      if (score < best) {
        best = score;
        best_j = j0 + jj;
      }
      if (kAll) out[j0 + jj] = score;
    }
  }

  if constexpr (kAll) {
    if (live)
      for (int j = n; j < L; ++j) out[j] = score;
  } else {
    dist_s[tid] = best;
    end_s[tid] = best_j;
    __syncthreads();
    if (live && q == 0) {
      const int32_t* d = dist_s + w * Q;
      const int32_t* en = end_s + w * Q;
      int bq = 0, bd = d[0], bm = ms_s[0];
      for (int qq = 1; qq < Q; ++qq) {
        const int dq = d[qq], mq2 = ms_s[qq];
        if (dq * bm < bd * mq2) {               // dq / mq2 < bd / bm
          bq = qq;
          bd = dq;
          bm = mq2;
        }
      }
      a.call[r] = bq;
      a.call[a.R + r] = bd;
      a.call[2 * static_cast<size_t>(a.R) + r] = en[bq];
    }
  }
}

template <int W>
void launch(int words, bool all, const Args& a, cudaStream_t stream) {
  if constexpr (W < kMaxWords) {
    if (words > W) return launch<W + 1>(words, all, a, stream);
  }
  const int threads = a.per_block * a.Q;
  const int blocks = (a.R + a.per_block - 1) / a.per_block;
  const size_t smem = table_bytes(a.Q, a.per_block, W, all) +
                      static_cast<size_t>(a.per_block) * a.tile;
  if (all)
    myers_perrow_kernel<W, true><<<blocks, threads, smem, stream>>>(a);
  else
    myers_perrow_kernel<W, false><<<blocks, threads, smem, stream>>>(a);
}

// k windows a block: at most 256 / Q, and no more than an even spread of
// the R windows over the SMs needs (in as few blocks a SM as k = 256 / Q
// would take)
int windows_per_block(int R, int Q) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t kmax = kBlockRows / Q, n = R, s = sms > 0 ? sms : 1;
  const int64_t waves = (n + s * kmax - 1) / (s * kmax);
  const int64_t k = (n + s * waves - 1) / (s * waves);
  return static_cast<int>(k < kmax ? k : kmax);
}

}  // namespace

// peqs: (Q, 5, W) 32-bit words, 1 <= Q <= 256; ms: (Q,) int32 in
// [1, 32 W]; texts: (R, L) int8 codes; tlens: (R,) int32. Row r * Q + q is
// text r against query q. collect_all 0: call (3, R) int32, each window's
// (q, dist, end) (scores unused, may be null); collect_all 1: scores
// (R Q, L) int32 (call unused). mode: 0 HW, 1 SHW. Any L: the columns are
// staged in tiles that fit the block's shared memory. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError() (0 on
// success).
extern "C" int cf_myers_perrow(const void* peqs, const void* ms,
                               const void* texts, const void* tlens,
                               void* call, void* scores, int Q, int R, int L,
                               int W, int mode, int collect_all,
                               void* stream) {
  if (Q < 1 || Q > kBlockRows || R < 0 || L < 0 || W < 1 ||
      W > kMaxWords || mode < kHW || mode > kSHW ||
      (collect_all != 0 && collect_all != 1) ||
      static_cast<int64_t>(R) * Q > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int k = windows_per_block(R, Q);
  // at most 16 KB of codes, and what the tables leave of the 48 KB (at
  // Q = 256, W = 8 and k = 1 the tables take 45 KB: tiles of 4,080)
  const int tile = std::max(
      1, std::min({L, kTileBytes / k,
                   (kSmemBytes - table_bytes(Q, k, W, collect_all == 1))
                       / k}));
  const Args a{static_cast<const uint32_t*>(peqs),
               static_cast<const int32_t*>(ms),
               static_cast<const int8_t*>(texts),
               static_cast<const int32_t*>(tlens),
               static_cast<int32_t*>(call),
               static_cast<int32_t*>(scores),
               Q, R, L, mode, k, tile};
  launch<1>(W, collect_all == 1, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
