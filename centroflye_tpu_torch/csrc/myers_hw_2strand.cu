// HW (infix) Myers edit distance for Hopper (sm_90a), on one or two strands.
//
// Replaces two TPU kernels of the JAX package's ops/myers_pallas_v3.py:
// myers_hw_pallas_v3_2strand (body _make_kernel_2strand, the recruitment
// scorer; STRANDS = 2) and myers_hw_pallas_v3 (body _make_kernel, its
// one-strand form; STRANDS = 1). For each text row b it computes the HW
// edit distance of the unit (peq_f) and, with two strands, of its reverse
// complement (peq_r) against text[0:lens[b]], and the first column that
// reaches each minimum:
//   - state: vp all ones, vn 0, score = best = m, bestj = -1;
//   - Eq = peq[c] for c < 4, 0 for c >= 4 (N and PAD match nothing);
//   - HW column update (no 1 shifted into hp at row 0);
//   - inc = bit (m-1) of hp minus bit (m-1) of hn, taken before the shift;
//   - only columns j < lens[b] move score and best; `improved` is strict,
//     so end is the first column reaching the minimum; lens 0 -> (m, -1).
// Padding bits above m have zero peq; carries only move upward, so they
// never reach row m-1.
//
// What bounds it: integer ALU and shuffle latency, not bytes. Each column
// is a chain of dependent word operations over W = ceil(m/32) words
// (65 for DXZ1) for each strand; a row reads one byte per column.
// DXZ1's 65 words of vp/vn/peq are too much state for one thread.
//
// Design: one warp per (row, strand), the strands of a row side by side
// in one block of 8 warps (STRANDS is a template parameter). Lane l holds
// the contiguous words [l*WPL, (l+1)*WPL) in registers (WPL = ceil(W/32) is a template parameter, 1..4: 3 for
// DXZ1, 4 for D6Z1). The Myers add ripples within a lane; the carry
// between lanes is a carry-lookahead over the warp: one __ballot_sync of
// the lanes that generate a carry and one of the lanes that propagate
// it, after which every lane's carry-in is a bit of one 32-bit add. The
// hp/hn shift hands each lane's top bit to the next lane with
// __shfl_up_sync, and the lane that owns row m-1 broadcasts the score
// change with __shfl_sync. Text comes in 32-column chunks, one byte per
// lane held in a register and handed out column by column with
// __shfl_sync, so the kernel uses no shared memory and no block barrier;
// each warp stops at its own row's length.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;                 // STRANDS warps per row
constexpr int kThreads = kWarpsPerBlock * 32;

template <int WPL, int STRANDS>
__global__ void __launch_bounds__(kThreads)
myers_hw_kernel(const int32_t* __restrict__ peq_f,
                        const int32_t* __restrict__ peq_r,
                        const int8_t* __restrict__ text_t,
                        const int32_t* __restrict__ lens,
                        int32_t* __restrict__ dist_f,
                        int32_t* __restrict__ end_f,
                        int32_t* __restrict__ dist_r,
                        int32_t* __restrict__ end_r,
                        int m, int W, int L, int B) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (kWarpsPerBlock / STRANDS) + warp / STRANDS;
  const int strand = STRANDS == 2 ? (warp & 1) : 0;
  if (row >= B) return;                 // whole warp: no barrier below

  const int32_t* peq = strand ? peq_r : peq_f;
  uint32_t p0[WPL], p1[WPL], p2[WPL], p3[WPL], vp[WPL], vn[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = lane * WPL + i;
    const bool ok = w < W;
    p0[i] = ok ? static_cast<uint32_t>(peq[0 * W + w]) : 0u;
    p1[i] = ok ? static_cast<uint32_t>(peq[1 * W + w]) : 0u;
    p2[i] = ok ? static_cast<uint32_t>(peq[2 * W + w]) : 0u;
    p3[i] = ok ? static_cast<uint32_t>(peq[3 * W + w]) : 0u;
    vp[i] = kFull;
    vn[i] = 0u;
  }
  const int tap_word = (m - 1) >> 5;
  const int tap_bit = (m - 1) & 31;
  const int tap_lane = tap_word / WPL;
  const int tap_i = tap_word % WPL;

  const int n = max(0, min(lens[row], L));
  int score = m, best = m, bestj = -1;

  for (int j0 = 0; j0 < n; j0 += 32) {
    const int jl = j0 + lane;
    const int ch = jl < n ? static_cast<int>(text_t[static_cast<size_t>(jl) * B + row]) : 4;
    const int cnt = min(32, n - j0);
    for (int t = 0; t < cnt; ++t) {
      const int c = __shfl_sync(kFull, ch, t);
      uint32_t eq[WPL], s[WPL];
      uint32_t carry = 0u;
      bool all_ones = true;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        eq[i] = c == 0 ? p0[i] : c == 1 ? p1[i] : c == 2 ? p2[i]
              : c == 3 ? p3[i] : 0u;
        const uint64_t sum = static_cast<uint64_t>(eq[i] & vp[i]) + vp[i] + carry;
        s[i] = static_cast<uint32_t>(sum);
        carry = static_cast<uint32_t>(sum >> 32);
        all_ones = all_ones && s[i] == kFull;
      }
      // lanes as the digits of one 32-digit number: generate = carry out
      // with carry-in 0, propagate = all words ones (carry out iff carry in)
      const unsigned gen = __ballot_sync(kFull, carry != 0u);
      const unsigned prop = __ballot_sync(kFull, all_ones);
      const unsigned a = gen | prop;
      uint32_t cin = (((a + gen) ^ a ^ gen) >> lane) & 1u;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const uint32_t v = s[i] + cin;
        cin = cin & (s[i] == kFull ? 1u : 0u);
        s[i] = v;
      }
      uint32_t d0[WPL], hp[WPL], hn[WPL];
      int tp = 0, tn = 0;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        d0[i] = (s[i] ^ vp[i]) | eq[i] | vn[i];
        hp[i] = vn[i] | ~(d0[i] | vp[i]);
        hn[i] = vp[i] & d0[i];
        if (i == tap_i) {
          tp = (hp[i] >> tap_bit) & 1u;
          tn = (hn[i] >> tap_bit) & 1u;
        }
      }
      const int inc = __shfl_sync(kFull, tp - tn, tap_lane);
      uint32_t hp_in = __shfl_up_sync(kFull, hp[WPL - 1] >> 31, 1);
      uint32_t hn_in = __shfl_up_sync(kFull, hn[WPL - 1] >> 31, 1);
      if (lane == 0) {                  // HW: nothing enters row 0
        hp_in = 0u;
        hn_in = 0u;
      }
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const uint32_t hps = (hp[i] << 1) | (i ? hp[i - 1] >> 31 : hp_in);
        const uint32_t hns = (hn[i] << 1) | (i ? hn[i - 1] >> 31 : hn_in);
        vp[i] = hns | ~(d0[i] | hps);
        vn[i] = hps & d0[i];
      }
      score += inc;
      if (score < best) {
        best = score;
        bestj = j0 + t;
      }
    }
  }
  if (lane == 0) {
    int32_t* dist = strand ? dist_r : dist_f;
    int32_t* end = strand ? end_r : end_f;
    dist[row] = best;
    end[row] = bestj;
  }
}

template <int WPL, int STRANDS>
void launch(const int32_t* peq_f, const int32_t* peq_r, const int8_t* text_t,
            const int32_t* lens, int32_t* dist_f, int32_t* end_f,
            int32_t* dist_r, int32_t* end_r, int m, int W, int L, int B,
            cudaStream_t stream) {
  constexpr int rows_per_block = kWarpsPerBlock / STRANDS;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  myers_hw_kernel<WPL, STRANDS><<<blocks, kThreads, 0, stream>>>(
      peq_f, peq_r, text_t, lens, dist_f, end_f, dist_r, end_r, m, W, L, B);
}

// Checks the sizes and picks the words-per-lane instance. The strand-r
// pointers are unused (null) with one strand.
template <int STRANDS>
int dispatch(const void* peq_f, const void* peq_r, const void* text_t,
             const void* lens, void* dist_f, void* end_f, void* dist_r,
             void* end_r, int m, int W, int L, int B, void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > 4 * 32 || L < 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int wpl = (W + 31) / 32;
  auto pf = static_cast<const int32_t*>(peq_f);
  auto pr = static_cast<const int32_t*>(peq_r);
  auto tx = static_cast<const int8_t*>(text_t);
  auto ln = static_cast<const int32_t*>(lens);
  auto df = static_cast<int32_t*>(dist_f);
  auto ef = static_cast<int32_t*>(end_f);
  auto dr = static_cast<int32_t*>(dist_r);
  auto er = static_cast<int32_t*>(end_r);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wpl) {
    case 1: launch<1, STRANDS>(pf, pr, tx, ln, df, ef, dr, er, m, W, L, B, st); break;
    case 2: launch<2, STRANDS>(pf, pr, tx, ln, df, ef, dr, er, m, W, L, B, st); break;
    case 3: launch<3, STRANDS>(pf, pr, tx, ln, df, ef, dr, er, m, W, L, B, st); break;
    default: launch<4, STRANDS>(pf, pr, tx, ln, df, ef, dr, er, m, W, L, B, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// peq_f, peq_r: (5, W) 32-bit words; text_t: (L, B) int8 codes; lens: (B,);
// outputs (B,) int32. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int cf_myers_hw_2strand(const void* peq_f, const void* peq_r,
                                   const void* text_t, const void* lens,
                                   void* dist_f, void* end_f, void* dist_r,
                                   void* end_r, int m, int W, int L, int B,
                                   void* stream) {
  return dispatch<2>(peq_f, peq_r, text_t, lens, dist_f, end_f, dist_r,
                     end_r, m, W, L, B, stream);
}

// One strand: peq (5, W) words; dist, end (B,) int32. Same contract.
extern "C" int cf_myers_hw_1strand(const void* peq, const void* text_t,
                                   const void* lens, void* dist, void* end,
                                   int m, int W, int L, int B, void* stream) {
  return dispatch<1>(peq, nullptr, text_t, lens, dist, end, nullptr, nullptr,
                     m, W, L, B, stream);
}
