// Per-row-query Myers edit distance for Hopper (sm_90a): kernel K4.
//
// The card's counterpart of the JAX package's ops/myers.py
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
//     empty alignment (score m_q) is never beaten;
//   - collect all: the score after every one of the L columns (masked
//     columns repeat it).
// The wrapper (ops/myers_cuda.myers_perrow) admits the decomposer's two
// calls: SHW collecting best, HW collecting all.
//
// A simple kernel: one thread per row, the W <= 8 words of vp and vn in
// registers (W a template parameter), the add's carry rippled word by word
// through a 64-bit sum. Eq comes from the query's table in global memory,
// which stays in L1 (the decomposer's 36 tables are 4.3 KB); a window's
// code is one byte that the Q threads of its rows read together. It moves
// few bytes and is bound by integer issue; at the decomposer's 1,152 rows
// the card holds few warps, so the time is one thread's chain of L column
// steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;        // small blocks: 1,152 rows spread over the SMs
constexpr int kMaxWords = 8;        // m <= 256
constexpr int kCodes = 5;

enum Mode { kHW = 0, kSHW = 1 };

struct Args {
  const int32_t* peqs;              // (Q, 5, W) 32-bit words
  const int32_t* ms;                // (Q,) query lengths, 1 <= ms <= 32 W
  const int8_t* texts;              // (R, L) codes
  const int32_t* tlens;             // (R,)
  int32_t* dist;                    // (R Q,), collect best
  int32_t* end;                     // (R Q,), collect best
  int32_t* scores;                  // (R Q, L), collect all
  int Q, R, L, mode;
};

template <int W, bool kAll>
__global__ void __launch_bounds__(kThreads)
myers_perrow_kernel(const Args a) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= static_cast<int64_t>(a.R) * a.Q) return;
  const int r = static_cast<int>(b / a.Q);
  const int q = static_cast<int>(b % a.Q);
  const uint32_t* peq =
      reinterpret_cast<const uint32_t*>(a.peqs) + static_cast<size_t>(q) * kCodes * W;
  const int mq = a.ms[q];
  const int tap_word = (mq - 1) >> 5;
  const int tap_bit = (mq - 1) & 31;
  const int n = max(0, min(a.tlens[r], a.L));
  const int8_t* text = a.texts + static_cast<size_t>(r) * a.L;
  int32_t* out = kAll ? a.scores + static_cast<size_t>(b) * a.L : nullptr;
  const uint32_t top = a.mode == kHW ? 0u : 1u;

  uint32_t vp[W], vn[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    vp[i] = 0xFFFFFFFFu;
    vn[i] = 0u;
  }
  int score = mq, best = mq, best_j = -1;
  for (int j = 0; j < n; ++j) {
    const int t = text[j];
    const uint32_t* eq = peq + (t >= 0 && t < 4 ? t : 4) * W;
    uint32_t carry = 0u, hp_in = top, hn_in = 0u, tap_p = 0u, tap_n = 0u;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t e = __ldg(eq + i);
      const uint64_t sum = static_cast<uint64_t>(e & vp[i]) + vp[i] + carry;
      carry = static_cast<uint32_t>(sum >> 32);
      const uint32_t d0 = (static_cast<uint32_t>(sum) ^ vp[i]) | e | vn[i];
      const uint32_t hp = vn[i] | ~(d0 | vp[i]);
      const uint32_t hn = vp[i] & d0;
      if (i == tap_word) {
        tap_p = hp;
        tap_n = hn;
      }
      const uint32_t hps = (hp << 1) | hp_in;
      const uint32_t hns = (hn << 1) | hn_in;
      hp_in = hp >> 31;
      hn_in = hn >> 31;
      vp[i] = hns | ~(d0 | hps);
      vn[i] = hps & d0;
    }
    score += static_cast<int>((tap_p >> tap_bit) & 1u) -
             static_cast<int>((tap_n >> tap_bit) & 1u);
    if (score < best) {
      best = score;
      best_j = j;
    }
    if (kAll) out[j] = score;
  }
  if (kAll) {
    for (int j = n; j < a.L; ++j) out[j] = score;
  } else {
    a.dist[b] = best;
    a.end[b] = best_j;
  }
}

template <int W>
void launch(int words, bool all, const Args& a, cudaStream_t stream) {
  if constexpr (W < kMaxWords) {
    if (words > W) return launch<W + 1>(words, all, a, stream);
  }
  const int64_t rows = static_cast<int64_t>(a.R) * a.Q;
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (all)
    myers_perrow_kernel<W, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    myers_perrow_kernel<W, false><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// peqs: (Q, 5, W) 32-bit words; ms: (Q,) int32 in [1, 32 W]; texts: (R, L)
// int8 codes; tlens: (R,) int32. Row r * Q + q is text r against query q.
// collect_all 0: dist, end (R Q,) int32 (scores unused, may be null);
// collect_all 1: scores (R Q, L) int32 (dist, end unused). mode: 0 HW,
// 1 SHW. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int cf_myers_perrow(const void* peqs, const void* ms,
                               const void* texts, const void* tlens,
                               void* dist, void* end, void* scores, int Q,
                               int R, int L, int W, int mode, int collect_all,
                               void* stream) {
  if (Q < 0 || R < 0 || L < 0 || W < 1 || W > kMaxWords || mode < kHW ||
      mode > kSHW || (collect_all != 0 && collect_all != 1) ||
      static_cast<int64_t>(R) * Q > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(R) * Q == 0) return 0;
  const Args a{static_cast<const int32_t*>(peqs),
               static_cast<const int32_t*>(ms),
               static_cast<const int8_t*>(texts),
               static_cast<const int32_t*>(tlens),
               static_cast<int32_t*>(dist), static_cast<int32_t*>(end),
               static_cast<int32_t*>(scores), Q, R, L, mode};
  launch<1>(W, collect_all == 1, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
