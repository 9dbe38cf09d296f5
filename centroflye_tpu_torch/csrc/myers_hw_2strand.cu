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
//
// What bounds it: integer issue, not bytes. A column costs about 11
// 32-bit operations per query word (the add with its carry, d0, hp, hn,
// two funnel shifts, vp, vn, the Eq fetch) over W = ceil(m/32) words (65
// for DXZ1) per strand, while a row reads one byte per column: a
// 2048 x 10240 batch is 21 MB, a few microseconds of memory time. With few
// rows (the fused step's 128) the card is not full: each warp has a
// scheduler to itself, and its own issue and dependent operations set the
// time. So the design spends as few instructions per word-column as it
// can, outside the words too, and keeps nothing but the words' own chain
// between one step and the next.
//
// Design: a wavefront over a group of G lanes (G = 8 or 32, a template
// parameter) per (row, strand); a warp holds 32/G problems, the
// strands of a row side by side. Lane l of a group holds the contiguous
// word slots [l*WPL, (l+1)*WPL) (WPL = ceil(W/G), a template parameter).
// At step s, lane l computes column s-1-l: all it needs from the rows
// below it for that column (the carry out of the add's top word, the top
// bits of hp and hn before the shift, and the code of the lane's next
// column) lane l-1 computed at step s-1, and one __shfl_up_sync of one
// packed word per step hands it on. There is no warp-wide carry-lookahead:
// the carry ripples within a lane and moves one lane a step. The group
// runs n + tap_lane + 1 steps for a row of n columns.
//   - The query sits at the top of the used lanes' bits: the pad =
//     lanes*WPL*32 - m spare bits lie below row 0, where a bit with Eq 0,
//     vp 1, vn 0 and zero inputs keeps its state and sends zeros upward.
//     So row m-1 is bit 31 of the last used lane's last slot (the tap
//     lane): the top bits of hp and hn that the packet carries anyway are
//     its score change, and only that lane's score, best and end count,
//     with no per-column broadcast and no runtime word or bit index.
//   - Eq: the block keeps each strand's peq in shared memory, laid out by
//     slot (5 x G*WPL words per strand, zero outside the query), and a lane
//     reads its WPL words with one load each. Lanes learn the code of
//     their next column a step early, so the load of the next column's Eq
//     is off the step's dependent chain. (Eq from bit planes of the query
//     in registers, three logic ops a word, was tried and was slower at
//     2048 rows, where integer issue rules.)
//   - Text: only lane 0 of a group reads it, one byte per column at
//     stride B, loaded kUnroll columns ahead. Before its column 0 a lane
//     is idle (its score change is 0), and past the row's length lane 0
//     feeds N: a column that matches nothing lowers no cell (by induction
//     down the column), so the score cannot improve there. So no lane
//     freezes or gates anything when a warp's groups differ in length.
// No TMA, wgmma or async-copy pipeline: the kernel moves few bytes and is
// bound by integer issue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 64;        // two warps a block: a small batch spreads over the SMs
constexpr int kUnroll = 4;          // steps per text prefetch (even)
constexpr int kMaxWords = 128;      // m <= 4096
constexpr int kCodes = 5;           // A, C, G, T, and N/PAD (Eq = 0)

struct Args {
  const int32_t* peq_f;
  const int32_t* peq_r;
  const int8_t* text_t;
  const int32_t* lens;
  int32_t* dist_f;
  int32_t* end_f;
  int32_t* dist_r;
  int32_t* end_r;
  int m, W, L, B;
};

template <int G, int WPL, int STRANDS>
__global__ void __launch_bounds__(kThreads)
myers_hw_wavefront(const Args a) {
  constexpr int S = G * WPL;                    // word slots of a group
  constexpr uint32_t kRow = 4u * S;             // bytes of one code's Eq row
  constexpr uint32_t kRowBits = 0x3FFFFFFCu;    // the Eq row offset in a packet
  __shared__ uint32_t table[STRANDS * kCodes * S];   // [strand][code][slot]
  const int used = (a.W + WPL - 1) / WPL;       // lanes holding words
  const int pad = used * WPL * 32 - a.m;        // neutral bits below row 0
  for (int k = threadIdx.x; k < STRANDS * kCodes * S; k += kThreads) {
    const int s = k / (kCodes * S), c = (k / S) % kCodes;
    const int32_t* peq = (s ? a.peq_r : a.peq_f) + c * a.W;
    auto word = [&](int w) -> uint32_t {
      return c < 4 && w >= 0 && w < a.W ? static_cast<uint32_t>(peq[w]) : 0u;
    };
    const int r0 = (k % S) * 32 - pad;          // query row at the slot's bit 0
    table[k] = __funnelshift_r(word(r0 >> 5), word((r0 >> 5) + 1), r0 & 31);
  }
  __syncthreads();

  const int gl = threadIdx.x & (G - 1);         // lane within the group
  const int problem = (blockIdx.x * kThreads + threadIdx.x) / G;
  const int row = problem / STRANDS;
  const int strand = problem % STRANDS;
  const int n = row < a.B ? max(0, min(a.lens[row], a.L)) : 0;
  const int n_warp = __reduce_max_sync(kFull, n);
  const int tap_lane = used - 1;
  const bool lead = gl == 0;
  // byte offset of this lane's slots in the code-0 row of its strand
  const uint32_t tab = (strand * kCodes * S + gl * WPL) * 4u;
  const char* table_bytes = reinterpret_cast<const char*>(table);

  // lane 0 reads the text, a column a call at stride B: the Eq row offset
  // of column j's code, N past the row
  const int n_lead = lead ? n : 0;
  const size_t stride = a.B;
  const int8_t* text = a.text_t + row;
  int j = 0;
  auto code_row = [&]() -> uint32_t {
    uint32_t r = 4u * kRow;
    if (j < n_lead) r = min(static_cast<uint32_t>(static_cast<uint8_t>(*text)), 4u) * kRow;
    ++j;
    text += stride;
    return r;
  };

  uint32_t vp[WPL], vn[WPL], eq_a[WPL], eq_b[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    vp[i] = kFull;
    vn[i] = 0u;
    eq_a[i] = 0u;                               // step 0 is idle everywhere
  }
  // packet from the lane below: hp top at bit 31, hn top at bit 30, the Eq
  // row offset of this lane's next column, carry at bit 0; lane 0's holds
  // column 0's row and nothing else
  uint32_t in = code_row();                     // lanes but 0: N
  int score = a.m, best = a.m, best_s = 0;

  // step s: this lane's column s-1-gl with Eq `eq`, and the load of its
  // next column's Eq into `eq_next`; lane 0 then takes `lead_row`
  auto step = [&](const uint32_t (&eq)[WPL], uint32_t (&eq_next)[WPL],
                  uint32_t lead_row, int s) {
    const uint32_t next_row = in & kRowBits;
    const char* src = table_bytes + tab + next_row;
#pragma unroll
    for (int i = 0; i < WPL; ++i)
      eq_next[i] = reinterpret_cast<const uint32_t*>(src)[i];
    uint32_t carry = in & 1u;
    uint32_t hp_lo = in, hn_lo = in << 1;       // bit 31: the tops from below
    uint32_t hp = 0u, hn = 0u;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const uint64_t sum =
          static_cast<uint64_t>(eq[i] & vp[i]) + vp[i] + carry;
      carry = static_cast<uint32_t>(sum >> 32);
      const uint32_t d0 = (static_cast<uint32_t>(sum) ^ vp[i]) | eq[i] | vn[i];
      hp = vn[i] | ~(d0 | vp[i]);
      hn = vp[i] & d0;
      const uint32_t hps = __funnelshift_l(hp_lo, hp, 1);
      const uint32_t hns = __funnelshift_l(hn_lo, hn, 1);
      hp_lo = hp;
      hn_lo = hn;
      vp[i] = hns | ~(d0 | hps);
      vn[i] = hps & d0;
    }
    // bit 31 of the top slot's hp and hn: the lane's top row, row m-1 in
    // the tap lane
    const uint32_t out =
        (hp & 0x80000000u) | ((hn >> 1) & 0x40000000u) | next_row | carry;
    in = __shfl_up_sync(kFull, out, 1, G);
    if (lead) in = lead_row;                    // HW: nothing enters row 0
    score += static_cast<int>(hp >> 31) - static_cast<int>(hn >> 31);
    if (score < best) {
      best = score;
      best_s = s;
    }
  };

  uint32_t ahead[kUnroll];                      // lane 0: rows of columns s+1..
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) ahead[u] = code_row();
  const int steps = n_warp > 0 ? n_warp + tap_lane + 1 : 0;
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
  if (gl == tap_lane && row < a.B) {
    (strand ? a.dist_r : a.dist_f)[row] = best;
    (strand ? a.end_r : a.end_f)[row] = best < a.m ? best_s - 1 - tap_lane : -1;
  }
}

template <int G, int STRANDS, int WPL = 1>
void launch(int wpl, const Args& a, cudaStream_t stream) {
  if constexpr (WPL < kMaxWords / G) {
    if (wpl > WPL) return launch<G, STRANDS, WPL + 1>(wpl, a, stream);
  }
  const int blocks = (a.B * STRANDS * G + kThreads - 1) / kThreads;
  myers_hw_wavefront<G, WPL, STRANDS><<<blocks, kThreads, 0, stream>>>(a);
}

// Checks the sizes and picks the (group, words-per-lane) instance. The
// strand-r pointers are unused (null) with one strand.
template <int STRANDS>
int dispatch(const Args& a, int group, void* stream) {
  if (a.m < 1 || a.W != (a.m + 31) / 32 || a.W > kMaxWords || a.L < 0 ||
      a.B < 0 || (group != 8 && group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0) return 0;
  const int wpl = (a.W + group - 1) / group;
  auto st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 8: launch<8, STRANDS>(wpl, a, st); break;
    default: launch<32, STRANDS>(wpl, a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// peq_f, peq_r: (5, W) 32-bit words; text_t: (L, B) int8 codes; lens: (B,);
// outputs (B,) int32; group: lanes per (row, strand), 8 or 32.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int cf_myers_hw_2strand(const void* peq_f, const void* peq_r,
                                   const void* text_t, const void* lens,
                                   void* dist_f, void* end_f, void* dist_r,
                                   void* end_r, int m, int W, int L, int B,
                                   int group, void* stream) {
  const Args a{static_cast<const int32_t*>(peq_f),
               static_cast<const int32_t*>(peq_r),
               static_cast<const int8_t*>(text_t),
               static_cast<const int32_t*>(lens),
               static_cast<int32_t*>(dist_f), static_cast<int32_t*>(end_f),
               static_cast<int32_t*>(dist_r), static_cast<int32_t*>(end_r),
               m, W, L, B};
  return dispatch<2>(a, group, stream);
}

// One strand: peq (5, W) words; dist, end (B,) int32. Same contract.
extern "C" int cf_myers_hw_1strand(const void* peq, const void* text_t,
                                   const void* lens, void* dist, void* end,
                                   int m, int W, int L, int B, int group,
                                   void* stream) {
  const Args a{static_cast<const int32_t*>(peq), nullptr,
               static_cast<const int8_t*>(text_t),
               static_cast<const int32_t*>(lens),
               static_cast<int32_t*>(dist), static_cast<int32_t*>(end),
               nullptr, nullptr, m, W, L, B};
  return dispatch<1>(a, group, stream);
}
