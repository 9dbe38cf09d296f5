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
//   - Eq = peq[c] for a code c in 0..3, zero (N and PAD match nothing) for
//     any other code;
//   - HW mode shifts a 0 into hp's bit 0, SHW and NW a 1 (the top row's
//     +1 a column);
//   - inc = bit (m-1) of hp minus the same bit of hn, before the shift;
//   - best takes the first column whose score is strictly below it, end
//     that column (global); final the score at j == lens[b] - 1.
// The new state is written to the out pointers (which may alias the in
// pointers: each lane reads its part of the row's state before it writes).
//
// What bounds it: 11 INT32 operations per query word per column scored
// (the add with its carry, d0, hp, hn, two shifts, vp, vn, the Eq fetch),
// as K1-K4; each code byte and the state move once, far below that. The
// sequence-parallel tier launches it on one row (8 reads a batch, one
// strand a call, 8 microbatches), so one group of lanes runs alone on the
// card and the time is its chain of dependent column steps: the issue
// rate of one warp (its instructions per column) and the latency of one
// step's chain set it, and the roofline bound is out of reach.
//
// Design: a wavefront over a group of G lanes a row (G = 8 or 32, a
// template parameter; a warp holds 32/G rows). Lane l holds the word slots
// [l*WPL, (l+1)*WPL) (WPL = ceil(W/G), a template parameter; m <= 4096).
// At step s, lane l computes the chunk's column s-1-l: what it needs from
// the rows below it for that column (the carry out of the add's top word,
// the top bits of hp and hn before the shift, and the Eq row of the lane's
// next column) lane l-1 computed at step s-1, and one __shfl_up_sync of
// one packed word a step hands it on. No ballot, no warp-wide lookahead,
// no per-column broadcast: the carry ripples within a lane and moves one
// lane a step. A row of n active columns takes n + tap_lane + 1 steps.
// Only lane 0 reads the text, kUnroll columns ahead; each lane loads its
// next column's Eq from the block's table in shared memory ([code][slot
// in lane][lane]) a step early, off the step's chain. One warp issues its
// instructions in order, so the step is written for the compiler's
// schedule: a 64-bit add a word, interleaved with that word's logic (an
// add.cc/addc chain in inline PTX, 8 steps a loop, a separate carry mask
// for lane 0 and a second shuffle for hn each ran slower on the H100), and
// the score's update as selects, not a branch, so that one step's tail
// overlaps the next step's chain.
//   - The state keeps its canonical layout, because it is compared bit for
//     bit and handed between devices, the bits above row m-1 of word W-1
//     included: word w holds rows 32w..32w+31, row 0 is bit 0 of word 0.
//     The off = used*WPL - W spare slots (used = ceil(W/WPL) lanes hold
//     words) lie below word 0 in lane 0, so word W-1 is the top slot of
//     the tap lane (used-1) and the tap is bit (m-1) & 31 of that lane's
//     own top hp and hn: no broadcast, no runtime word index. A spare slot
//     has Eq 0 and a state that a column leaves as it is while it sends
//     the mode's top-row input up to word 0 and no carry: vp all ones and
//     vn 0 in HW (hp = hn = 0 out), vp = vn = 0 in SHW and NW (hp all ones
//     out; lane 0 shifts a 1 into its bottom slot). Words past W (lanes
//     above the tap lane, and a carry out of word W-1) feed nothing below
//     them and are never written.
//   - Freezing is exact, per lane: a lane updates vp, vn and the scores
//     only while its column lies in [c0, min(c0 + C, lens[b])). Outside it
//     the lane still takes part in the shuffle, and what it hands up feeds
//     only the same inactive column of the lane above. (K1 feeds N past a
//     row's end instead; that changes vp and vn, so it would change the
//     carried state.) A row with no active column writes its state back
//     unchanged.
// No TMA, wgmma or async-copy pipeline: the kernel moves few bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 64;        // two warps a block: few rows spread over the SMs
constexpr int kUnroll = 4;          // steps per text prefetch (even)
constexpr int kMaxWords = 128;      // m <= 4096
constexpr int kCodes = 5;           // A, C, G, T, and N/PAD (Eq = 0)

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

template <int G, int WPL>
__global__ void __launch_bounds__(kThreads)
myers_carry_wavefront(const Args a) {
  constexpr int S = G * WPL;                    // word slots of a group
  constexpr uint32_t kRow = 4u * S;             // bytes of one code's Eq row
  constexpr uint32_t kRowBits = 0x3FFFFFFCu;    // the Eq row offset in a packet
  __shared__ uint32_t table[kCodes * S];        // [code][i][lane]
  const int used = (a.W + WPL - 1) / WPL;       // lanes holding words
  const int off = used * WPL - a.W;             // spare slots below word 0
  for (int k = threadIdx.x; k < kCodes * S; k += kThreads) {
    const int c = k / S, i = (k % S) / G, l = k % G;
    const int w = l * WPL + i - off;
    table[k] = c < 4 && w >= 0 && w < a.W ? a.peq[c * a.W + w] : 0u;
  }
  __syncthreads();

  const int gl = threadIdx.x & (G - 1);         // lane within the group
  const int row = (blockIdx.x * kThreads + threadIdx.x) / G;
  const bool live = row < a.B;
  const int tap_lane = used - 1;
  const int tap_bit = (a.m - 1) & 31;
  const int len = live ? a.lens[row] : 0;
  const int n = live ? max(0, min(a.C, len - a.c0)) : 0;   // active columns
  const int steps = __reduce_max_sync(kFull, n > 0 ? n + tap_lane + 1 : 0);
  const size_t B = a.B;
  const size_t base = live ? row * static_cast<size_t>(a.W) : 0;
  const bool lead = gl == 0;
  const uint32_t top = a.global_mode ? 0x80000000u : 0u;  // into row 0's hp

  uint32_t vp[WPL], vn[WPL], eq_a[WPL], eq_b[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = gl * WPL + i - off;
    const bool word = live && w >= 0 && w < a.W;
    vp[i] = word ? a.vp_in[base + w] : (a.global_mode ? 0u : kFull);
    vn[i] = word ? a.vn_in[base + w] : 0u;
    eq_a[i] = 0u;                               // step 0 is idle everywhere
  }
  int score = 0, best = 0, end = 0, fin = 0, best_s = -1;
  if (live) {
    score = a.sc_in[row];
    best = a.sc_in[B + row];
    end = a.sc_in[2 * B + row];
    fin = a.sc_in[3 * B + row];
  }
  const char* table_bytes = reinterpret_cast<const char*>(table) + 4 * gl;

  // lane 0 reads the text: column j's Eq row offset (N past the row), and
  // the mode's bit into row 0's hp
  const int n_lead = lead ? n : 0;
  const int8_t* text = a.text + (live ? row * static_cast<size_t>(a.ld) : 0);
  int j = 0;
  auto code_row = [&]() -> uint32_t {
    uint32_t r = 4u * kRow;
    if (j < n_lead) r = min(static_cast<uint32_t>(static_cast<uint8_t>(text[j])), 4u) * kRow;
    ++j;
    return r | top;
  };

  // packet from the lane below: hp top at bit 31, hn top at bit 30, the Eq
  // row offset of this lane's next column, carry at bit 0; lane 0's holds
  // its next column's row and the mode's bit
  uint32_t in = code_row();

  // step s: this lane's column s-1-gl with Eq `eq`, and the load of its
  // next column's Eq into `eq_next`; lane 0 then takes `lead_row`
  auto step = [&](const uint32_t (&eq)[WPL], uint32_t (&eq_next)[WPL],
                  uint32_t lead_row, int s) {
    const uint32_t next_row = in & kRowBits;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(table_bytes + next_row);
#pragma unroll
    for (int i = 0; i < WPL; ++i) eq_next[i] = src[i * G];
    uint32_t sum[WPL];
    uint32_t carry = in & 1u;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const uint64_t t = static_cast<uint64_t>(eq[i] & vp[i]) + vp[i] + carry;
      sum[i] = static_cast<uint32_t>(t);
      carry = static_cast<uint32_t>(t >> 32);
    }
    const bool act = static_cast<unsigned>(s - 1 - gl) < static_cast<unsigned>(n);
    uint32_t hp_lo = in, hn_lo = in << 1;       // bit 31: the tops from below
    uint32_t hp = 0u, hn = 0u;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const uint32_t d0 = (sum[i] ^ vp[i]) | eq[i] | vn[i];
      hp = vn[i] | ~(d0 | vp[i]);
      hn = vp[i] & d0;
      const uint32_t hps = __funnelshift_l(hp_lo, hp, 1);
      const uint32_t hns = __funnelshift_l(hn_lo, hn, 1);
      hp_lo = hp;
      hn_lo = hn;
      if (act) {
        vp[i] = hns | ~(d0 | hps);
        vn[i] = hps & d0;
      }
    }
    const uint32_t out =
        (hp & 0x80000000u) | ((hn >> 1) & 0x40000000u) | next_row | carry;
    in = __shfl_up_sync(kFull, out, 1, G);
    if (lead) in = lead_row;
    // counts in the tap lane
    const int inc = static_cast<int>((hp >> tap_bit) & 1u) -
                    static_cast<int>((hn >> tap_bit) & 1u);
    score += act ? inc : 0;
    const bool improved = act && score < best;
    best = improved ? score : best;
    best_s = improved ? s : best_s;
  };

  uint32_t ahead[kUnroll];                      // lane 0: rows of columns s+1..
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) ahead[u] = code_row();
  for (int s0 = 0; s0 < steps; s0 += kUnroll) {
    uint32_t later[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) later[u] = code_row();
#pragma unroll
    for (int u = 0; u < kUnroll; u += 2) {     // Eq buffers swap, not copied
      step(eq_a, eq_b, ahead[u], s0 + u);
      step(eq_b, eq_a, ahead[u + 1], s0 + u + 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ahead[u] = later[u];
  }

  __syncwarp();                                 // every lane has read its state
  if (!live) return;
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const int w = gl * WPL + i - off;
    if (w >= 0 && w < a.W) {
      a.vp_out[base + w] = vp[i];
      a.vn_out[base + w] = vn[i];
    }
  }
  if (gl == tap_lane) {
    a.sc_out[row] = score;
    a.sc_out[B + row] = best;
    a.sc_out[2 * B + row] = best_s >= 0 ? a.c0 + best_s - 1 - tap_lane : end;
    a.sc_out[3 * B + row] = n > 0 && a.c0 + n == len ? score : fin;
  }
}

template <int G, int WPL = 1>
void launch(int wpl, const Args& a, cudaStream_t stream) {
  if constexpr (WPL < kMaxWords / G) {
    if (wpl > WPL) return launch<G, WPL + 1>(wpl, a, stream);
  }
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(a.B) * G + kThreads - 1) / kThreads);
  myers_carry_wavefront<G, WPL><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// peq: (5, W) 32-bit words, W = ceil(m / 32) <= 128; text: row b's codes
// for the chunk's C columns at text + b * ld; lens: (B,) int32 global
// lengths; vp_in, vn_in: (B, W) words; sc_in: (4, B) int32 (score, best,
// end, final); the out pointers take the same shapes and may alias the in
// pointers. Columns are the global [c0, c0 + C). mode: 0 HW, 1 SHW or NW
// (a 1 shifted into hp at row 0). group: lanes a row, 8 or 32. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int cf_myers_carry(const void* peq, const void* text,
                              const void* lens, const void* vp_in,
                              const void* vn_in, const void* sc_in,
                              void* vp_out, void* vn_out, void* sc_out,
                              int m, int W, int C, int B, int ld, int c0,
                              int global_mode, int group, void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > kMaxWords || C < 0 || B < 0 ||
      ld < C || c0 < 0 || (global_mode != 0 && global_mode != 1) ||
      (group != 8 && group != 32))
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
  const int wpl = (W + group - 1) / group;
  auto st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 8: launch<8>(wpl, a, st); break;
    default: launch<32>(wpl, a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
