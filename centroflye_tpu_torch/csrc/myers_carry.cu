// Myers edit distance over one chunk of text columns with the DP state
// carried in and out, for Hopper (sm_90a): kernel K5.
//
// The card's counterpart of the JAX package's parallel/seq_parallel.py
// chunk_scan (a jnp scan over myers_column_update, ops/myers.py:90, no
// Pallas kernel): the sequence-parallel tier scans a read's columns chunk
// by chunk, each chunk on the next device of the mesh, and hands the whole
// DP state on between them. For row b, from its carried state (vp, vn: W
// 32-bit words; score, best, end, final: int32), over the chunk's global
// columns j in [c0, c0 + C):
//   - active = j < lens[b]: a column at or past the row's length changes
//     nothing, so the state is frozen there;
//   - Eq = peq[c] for a code c in 0..3, peq[4] (zero: N and PAD match
//     nothing) for any other code;
//   - HW mode shifts a 0 into hp's bit 0, SHW and NW a 1 (the top row's
//     +1 a column);
//   - inc = bit (m-1) of hp minus the same bit of hn, before the shift;
//   - best takes the first column whose score is strictly below it, end
//     that column (global); final the score at j == lens[b] - 1.
// The new state is written to the out pointers (which may alias the in
// pointers: each row reads its state before it writes it).
//
// Bound: 11 INT32 operations per query word per column per row (the add,
// d0, hp, hn, two shifts, vp, vn), as K1's; each code byte and the state
// move once, far below that. The sequence-parallel tier holds few rows (8
// reads a batch, one strand a call), so the card is far from full and the
// time is one row's chain of dependent column steps.
//
// Design: one warp a row, simple and exact. Lane l holds the contiguous
// words [l*WPL, (l+1)*WPL) of vp and vn in registers (WPL = ceil(W/32), a
// template parameter; m <= 4096). A column's add runs as a local carry
// chain in each lane and a warp-wide carry lookahead: each lane's carry
// out with no carry in (g) and whether its sum is all ones (p, it passes a
// carry on) are two ballots, and the carries into the lanes are the bits
// of ((G + (G | P)) ^ P), one 32-bit add. The shifts of hp and hn take the
// top bits of the lane below by one shuffle. The lane holding row m-1
// keeps score, best, end and final. Codes are loaded 32 columns at a time,
// one a lane, and broadcast by a shuffle; the peq table sits in shared
// memory laid out by word slot. The warp walks only the row's active
// columns of the chunk, so freezing costs nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;           // rows a block
constexpr int kMaxWords = 128;      // m <= 4096
constexpr int kCodes = 5;

struct Args {
  const uint32_t* peq;              // (5, W) words
  const int8_t* text;               // row b's chunk at text + b * ld
  const int32_t* lens;              // (B,) global lengths
  const uint32_t* vp_in;            // (B, W)
  const uint32_t* vn_in;
  const int32_t* sc_in;             // (4, B): score, best, end, final
  uint32_t* vp_out;
  uint32_t* vn_out;
  int32_t* sc_out;
  int m, W, C, B, ld, c0, global_mode;
};

template <int WPL>
__global__ void __launch_bounds__(32 * kWarps)
myers_carry_kernel(const Args a) {
  constexpr int kSlots = 32 * WPL;
  __shared__ uint32_t table[kCodes * kSlots];   // [code][slot], 0 past W
  for (int k = threadIdx.x; k < kCodes * kSlots; k += 32 * kWarps) {
    const int c = k / kSlots, w = k % kSlots;
    table[k] = c < 4 && w < a.W ? a.peq[c * a.W + w] : 0u;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.B) return;                       // the whole warp
  const int tap_word = (a.m - 1) >> 5;
  const int tap_lane = tap_word / WPL, tap_i = tap_word % WPL;
  const int tap_bit = (a.m - 1) & 31;
  const size_t B = a.B;

  uint32_t vp[WPL], vn[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = lane * WPL + i;
    vp[i] = w < a.W ? a.vp_in[row * static_cast<size_t>(a.W) + w] : 0u;
    vn[i] = w < a.W ? a.vn_in[row * static_cast<size_t>(a.W) + w] : 0u;
  }
  int score = a.sc_in[row], best = a.sc_in[B + row];
  int end = a.sc_in[2 * B + row], fin = a.sc_in[3 * B + row];
  const int len = a.lens[row];
  const int j_end = min(a.c0 + a.C, len);       // active columns: [c0, j_end)
  const uint32_t lane_bit = 1u << lane;
  const uint32_t top_in = a.global_mode ? 1u : 0u;
  const int8_t* text = a.text + row * static_cast<size_t>(a.ld);

  for (int j0 = a.c0; j0 < j_end; j0 += 32) {
    const int jl = j0 + lane;
    int code = 4;
    if (jl < j_end) {
      const int t = text[jl - a.c0];
      code = t >= 0 && t < 4 ? t : 4;
    }
    const int n = min(32, j_end - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int c = __shfl_sync(kFull, code, jj);
      const uint32_t* eq_row = table + c * kSlots + lane * WPL;
      uint32_t eq[WPL], s[WPL];
#pragma unroll
      for (int i = 0; i < WPL; ++i) eq[i] = eq_row[i];
      // the lane's words of (eq & vp) + vp with no carry in
      uint32_t carry = 0u, ones = kFull;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const uint64_t sum =
            static_cast<uint64_t>(eq[i] & vp[i]) + vp[i] + carry;
        s[i] = static_cast<uint32_t>(sum);
        carry = static_cast<uint32_t>(sum >> 32);
        ones &= s[i];
      }
      // carry into each lane: a ripple over the lanes as one 32-bit add
      const uint32_t G = __ballot_sync(kFull, carry != 0u);
      const uint32_t P = __ballot_sync(kFull, ones == kFull);
      uint32_t cin = (((G + (G | P)) ^ P) & lane_bit) ? 1u : 0u;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {           // + the carry from below
        s[i] += cin;
        cin &= s[i] == 0u ? 1u : 0u;
      }
      uint32_t hp[WPL], hn[WPL], d0[WPL];
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        d0[i] = (s[i] ^ vp[i]) | eq[i] | vn[i];
        hp[i] = vn[i] | ~(d0[i] | vp[i]);
        hn[i] = vp[i] & d0[i];
      }
      // the top bits of hp and hn of the lane below; lane 0 takes the
      // top row's bit
      const uint32_t tops = (hp[WPL - 1] >> 31) | ((hn[WPL - 1] >> 31) << 1);
      const uint32_t from = __shfl_up_sync(kFull, tops, 1);
      uint32_t hp_lo = lane == 0 ? top_in << 31 : from << 31;
      uint32_t hn_lo = lane == 0 ? 0u : (from >> 1) << 31;
      int inc = 0;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        if (i == tap_i)
          inc = static_cast<int>((hp[i] >> tap_bit) & 1u) -
                static_cast<int>((hn[i] >> tap_bit) & 1u);
        const uint32_t hps = __funnelshift_l(hp_lo, hp[i], 1);
        const uint32_t hns = __funnelshift_l(hn_lo, hn[i], 1);
        hp_lo = hp[i];
        hn_lo = hn[i];
        vp[i] = hns | ~(d0[i] | hps);
        vn[i] = hps & d0[i];
      }
      if (lane == tap_lane) {
        const int j = j0 + jj;
        score += inc;
        if (score < best) {
          best = score;
          end = j;
        }
        if (j == len - 1) fin = score;
      }
    }
  }

  __syncwarp();                                 // every lane has read its state
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = lane * WPL + i;
    if (w < a.W) {
      a.vp_out[row * static_cast<size_t>(a.W) + w] = vp[i];
      a.vn_out[row * static_cast<size_t>(a.W) + w] = vn[i];
    }
  }
  if (lane == tap_lane) {
    a.sc_out[row] = score;
    a.sc_out[B + row] = best;
    a.sc_out[2 * B + row] = end;
    a.sc_out[3 * B + row] = fin;
  }
}

template <int WPL = 1>
void launch(int wpl, const Args& a, cudaStream_t stream) {
  if constexpr (WPL < kMaxWords / 32) {
    if (wpl > WPL) return launch<WPL + 1>(wpl, a, stream);
  }
  const int blocks = (a.B + kWarps - 1) / kWarps;
  myers_carry_kernel<WPL><<<blocks, 32 * kWarps, 0, stream>>>(a);
}

}  // namespace

// peq: (5, W) 32-bit words, W = ceil(m / 32) <= 128; text: row b's codes
// for the chunk's C columns at text + b * ld; lens: (B,) int32 global
// lengths; vp_in, vn_in: (B, W) words; sc_in: (4, B) int32 (score, best,
// end, final); the out pointers take the same shapes and may alias the in
// pointers. Columns are the global [c0, c0 + C). mode: 0 HW, 1 SHW or NW
// (a 1 shifted into hp at row 0). Launches on `stream`, allocates nothing,
// does not synchronise. Returns cudaGetLastError() (0 on success).
extern "C" int cf_myers_carry(const void* peq, const void* text,
                              const void* lens, const void* vp_in,
                              const void* vn_in, const void* sc_in,
                              void* vp_out, void* vn_out, void* sc_out,
                              int m, int W, int C, int B, int ld, int c0,
                              int global_mode, void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > kMaxWords || C < 0 || B < 0 ||
      ld < C || c0 < 0 || (global_mode != 0 && global_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Args a{static_cast<const uint32_t*>(peq),
               static_cast<const int8_t*>(text),
               static_cast<const int32_t*>(lens),
               static_cast<const uint32_t*>(vp_in),
               static_cast<const uint32_t*>(vn_in),
               static_cast<const int32_t*>(sc_in),
               static_cast<uint32_t*>(vp_out),
               static_cast<uint32_t*>(vn_out),
               static_cast<int32_t*>(sc_out),
               m, W, C, B, ld, c0, global_mode};
  launch<1>((W + 31) / 32, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
