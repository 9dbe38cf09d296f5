// Threshold-k banded HW (infix) Myers edit distance for Hopper (sm_90a).
//
// Replaces the TPU kernel myers_hw_pallas_v3_banded (body
// _make_kernel_banded) of the JAX package's ops/myers_pallas_v3.py. For
// each text row b it computes what the unbanded HW kernel computes, the
// distance of the query against text[0:lens[b]] and the first column that
// reaches it, but only where that distance is <= k; elsewhere it returns
// (m, -1). Only the query rows inside an Ukkonen band are computed.
//
// The band (rule and granularity):
//   - A band block is 1024 query rows: one 32-bit word in each lane of the
//     warp. The band is blocks [0, last]; each warp (one text row) keeps
//     its own `last`. The TPU kernel has one edge per 128-lane tile, at
//     256-row granularity; the output does not depend on the band.
//   - Invariant before each column: every cell whose true value is <= kvec
//     lies in the band and is computed exactly; every computed cell is at
//     least its true value. kvec starts at k and becomes the best score
//     once one is found (the TPU kernel's kvec rule), so it never grows.
//   - Start: last = the block holding row k (rows 0..k), as in the TPU
//     kernel and native/myers.cpp hw_banded.
//   - Expansion, checked before every column: if the computed score at the
//     band's bottom row is <= kvec, block last+1 joins, its vp all ones and
//     vn 0 (the all-increment profile below that bottom score, which only
//     overestimates) and its bottom score that bottom score + 1024. Rows
//     below the old band were all > kvec, so one block per column keeps
//     the invariant.
//   - Reduction, checked after every column: if the bottom score is at
//     least kvec + 1024, every cell of block last is > kvec and the block
//     leaves (one block per column). This is the reduction rule of
//     native/myers.cpp hw_banded (score[last] >= k + kWord), per column.
//   - The tap: row m-1 lies in block tap_slot. While the band does not
//     reach it, no best is updated. When the band grows into it, the row
//     m-1 score is seeded from the fresh block's profile:
//     bottom score of the old band + (m-1) - (first row of the block) + 1.
//   - improved = tapped & (rs <= kvec) & (rs < best), then kvec = rs, so
//     end is the first column reaching the minimum (the TPU kernel's rule).
//
// What bounds it: integer ALU, ballot and shuffle latency, as for the
// unbanded kernel (myers_hw_2strand.cu). The band pays only if the warp's
// work shrinks, so the layout is strided: lane l holds words l, l+32,
// l+64, ... (slot i = words 32i..32i+31, one band block). A column runs
// the slots i <= last only, so a row whose band stays in block 0 does one
// slot of work where the unbanded kernel does ceil(W/32) words per lane.
// The price: each slot has its own carry-lookahead (two __ballot_sync:
// generate, propagate; the carry out of lane 31 enters the next slot's
// lane 0 as a warp-uniform value) and its own hp/hn shift (two
// __ballot_sync of the lanes' top bits; lane 0 takes the previous slot's
// bit 31, which is also the change of that block's bottom score).
// Text comes in 32-column chunks through __shfl_sync, as in the unbanded
// kernel. No shared memory, no block barrier; every band decision is
// warp-uniform.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;                 // one text row each
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlockRows = 32 * 32;               // query rows of one slot

template <int NS>
__global__ void __launch_bounds__(kThreads)
myers_hw_banded_kernel(const int32_t* __restrict__ peq,
                       const int8_t* __restrict__ text_t,
                       const int32_t* __restrict__ lens,
                       int32_t* __restrict__ dist,
                       int32_t* __restrict__ end,
                       int m, int W, int L, int B, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;                 // whole warp: no barrier below

  uint32_t p0[NS], p1[NS], p2[NS], p3[NS], vp[NS], vn[NS];
  int bs[NS];                           // score at each slot's bottom row
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int w = i * 32 + lane;
    const bool ok = w < W;
    p0[i] = ok ? static_cast<uint32_t>(peq[0 * W + w]) : 0u;
    p1[i] = ok ? static_cast<uint32_t>(peq[1 * W + w]) : 0u;
    p2[i] = ok ? static_cast<uint32_t>(peq[2 * W + w]) : 0u;
    p3[i] = ok ? static_cast<uint32_t>(peq[3 * W + w]) : 0u;
    vp[i] = kFull;
    vn[i] = 0u;
    bs[i] = (i + 1) * kBlockRows;
  }
  const int tap_word = (m - 1) >> 5;
  const int tap_bit = (m - 1) & 31;
  const int tap_lane = tap_word & 31;
  const int tap_slot = tap_word >> 5;

  int last = min((k + kBlockRows) / kBlockRows - 1, NS - 1);   // rows 0..k
  int kvec = k, best = m, bestj = -1;
  int rs = m;                           // row m-1 score, while tapped
  const int n = max(0, min(lens[row], L));

  for (int j0 = 0; j0 < n; j0 += 32) {
    const int jl = j0 + lane;
    const int ch = jl < n ? static_cast<int>(text_t[static_cast<size_t>(jl) * B + row]) : 4;
    const int cnt = min(32, n - j0);
    for (int t = 0; t < cnt; ++t) {
      const int c = __shfl_sync(kFull, ch, t);

      // expansion: the band's bottom score after the previous column
      int bl = bs[0];
#pragma unroll
      for (int i = 1; i < NS; ++i) bl = i == last ? bs[i] : bl;
      if (last < NS - 1 && bl <= kvec) {
        ++last;
#pragma unroll
        for (int i = 1; i < NS; ++i) {
          if (i == last) {
            vp[i] = kFull;
            vn[i] = 0u;
            bs[i] = bl + kBlockRows;
          }
        }
        if (last == tap_slot) rs = bl + m - last * kBlockRows;
      }

      // one Myers column over the band's slots, carries upward
      uint32_t cin = 0u;                // into lane 0 of the slot
      uint32_t hp_top = 0u, hn_top = 0u;  // HW: nothing enters row 0
      int inc = 0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i <= last) {
          const uint32_t eq = c == 0 ? p0[i] : c == 1 ? p1[i] : c == 2 ? p2[i]
                            : c == 3 ? p3[i] : 0u;
          const uint64_t sum = static_cast<uint64_t>(eq & vp[i]) + vp[i];
          const uint32_t s0 = static_cast<uint32_t>(sum);
          // lanes as the digits of one 32-digit number, carry-in `cin`
          const unsigned gen = __ballot_sync(kFull, (sum >> 32) != 0u);
          const unsigned prop = __ballot_sync(kFull, s0 == kFull);
          const unsigned a = gen | prop;
          const uint64_t tot = static_cast<uint64_t>(a) + gen + cin;
          const uint32_t carries = static_cast<uint32_t>(tot) ^ a ^ gen;
          cin = static_cast<uint32_t>(tot >> 32);
          const uint32_t s = s0 + ((carries >> lane) & 1u);
          const uint32_t d0 = (s ^ vp[i]) | eq | vn[i];
          const uint32_t hp = vn[i] | ~(d0 | vp[i]);
          const uint32_t hn = vp[i] & d0;
          if (i == tap_slot) {
            const int tp = (hp >> tap_bit) & 1u;
            const int tn = (hn >> tap_bit) & 1u;
            inc = __shfl_sync(kFull, tp - tn, tap_lane);
          }
          const unsigned hpb = __ballot_sync(kFull, hp >> 31);
          const unsigned hnb = __ballot_sync(kFull, hn >> 31);
          const uint32_t hp_in = lane ? (hpb >> (lane - 1)) & 1u : hp_top;
          const uint32_t hn_in = lane ? (hnb >> (lane - 1)) & 1u : hn_top;
          hp_top = hpb >> 31;
          hn_top = hnb >> 31;
          bs[i] += static_cast<int>(hp_top) - static_cast<int>(hn_top);
          const uint32_t hps = (hp << 1) | hp_in;
          const uint32_t hns = (hn << 1) | hn_in;
          vp[i] = hns | ~(d0 | hps);
          vn[i] = hps & d0;
        }
      }

      if (last >= tap_slot) {
        rs += inc;
        if (rs <= kvec && rs < best) {
          best = rs;
          bestj = j0 + t;
          kvec = rs;
        }
      }

      // reduction: every cell of block `last` > kvec
      bl = bs[0];
#pragma unroll
      for (int i = 1; i < NS; ++i) bl = i == last ? bs[i] : bl;
      if (last > 0 && bl >= kvec + kBlockRows) --last;
    }
  }
  if (lane == 0) {
    const bool ok = best <= k;
    dist[row] = ok ? best : m;
    end[row] = ok ? bestj : -1;
  }
}

template <int NS>
void launch(const int32_t* peq, const int8_t* text_t, const int32_t* lens,
            int32_t* dist, int32_t* end, int m, int W, int L, int B, int k,
            cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  myers_hw_banded_kernel<NS><<<blocks, kThreads, 0, stream>>>(
      peq, text_t, lens, dist, end, m, W, L, B, k);
}

}  // namespace

// peq: (5, W) 32-bit words; text_t: (L, B) int8 codes; lens: (B,); k >= 0.
// dist, end: (B,) int32. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int cf_myers_hw_banded(const void* peq, const void* text_t,
                                  const void* lens, void* dist, void* end,
                                  int m, int W, int L, int B, int k,
                                  void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > 4 * 32 || L < 0 || B < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (k > m) k = m;           // every distance is <= m: same outputs
  auto pq = static_cast<const int32_t*>(peq);
  auto tx = static_cast<const int8_t*>(text_t);
  auto ln = static_cast<const int32_t*>(lens);
  auto ds = static_cast<int32_t*>(dist);
  auto en = static_cast<int32_t*>(end);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((W + 31) / 32) {
    case 1: launch<1>(pq, tx, ln, ds, en, m, W, L, B, k, st); break;
    case 2: launch<2>(pq, tx, ln, ds, en, m, W, L, B, k, st); break;
    case 3: launch<3>(pq, tx, ln, ds, en, m, W, L, B, k, st); break;
    default: launch<4>(pq, tx, ln, ds, en, m, W, L, B, k, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
