// Threshold-k HW (infix) Myers edit distance for Hopper (sm_90a).
//
// Replaces the TPU kernel myers_hw_pallas_v3_banded (body
// _make_kernel_banded) of the JAX package's ops/myers_pallas_v3.py. For
// each text row b it computes what the unbanded HW kernel computes, the
// distance of the query against text[0:lens[b]] and the first column that
// reaches it, but only where that distance is <= k; elsewhere it returns
// (m, -1).
//
// What bounds it: integer issue, as for the unbanded kernel
// (myers_hw_2strand.cu): about 11 operations per query word per text
// column. The TPU kernel saves work with an Ukkonen band inside its column
// loop. On this card that does not pay: the lanes of a group that would
// sit above the band still issue every instruction of the warp. So the
// band leaves the inner loop and becomes two exact cuts of the work, each
// run by the unbanded kernel's step loop as it stands:
//
//   - Pass 1, a prefix filter: every row on the first q = r0 query rows
//     (whole words of the peq). An alignment of all m rows ending at
//     column j passes row r0-1 at some column j' <= j and adds no negative
//     cost after it, so the full distance is at least the prefix's. A row
//     whose prefix distance exceeds k is (m, -1). The others (the
//     survivors) go to a list, by atomicAdd. With r0 = m, pass 1 is the
//     exact pass below and there is no pass 2.
//   - Pass 2, the exact pass: the survivors on all m rows. The wrapper
//     reads the survivor count back (4 bytes) to size this grid.
//   - Column windows, in either pass, so that few rows still fill the
//     card: window w owns columns [wS, (w+1)S) and is scored from
//     c0 = max(0, wS - overlap), overlap = q + k - 1. An alignment of cost
//     <= k spans at most q + k columns, so the window that owns the true
//     first minimum column scores it exactly; a fresh start at c0 only
//     constrains the alignment, so every window scores each column at or
//     above its true value. In the exact pass each window that reaches
//     <= k takes a 64-bit atomicMin of (dist << 32) | end on its row: the
//     least distance, then its first column (a window whose earlier
//     column ties the minimum would need a true score at or below it
//     there). In pass 1 such a window claims its row once (an atomicCAS
//     of the packed minimum from (m, -1) to (m, -2)) and lists it.
//   - A last small kernel maps the packed minima to (dist, end):
//     a distance above k or equal to m (no column improved) is (m, -1).
//
// The step loop (one problem: a row, a window, q query rows) is
// myers_hw_2strand.cu's, one strand: a wavefront over a group of G lanes
// (G = 8 or 32), lane l holding word slots [l*WPL, (l+1)*WPL) of the
// query stored at the top of the used lanes' bits, so that row q-1 is bit
// 31 of the tap lane's last slot; Eq from a shared-memory table by slot;
// lane 0 reads the text a column a step ahead at stride B from
// text_t + c0*B + row and feeds N past the window's columns; one
// __shfl_up_sync of a packed word per step. That file's header explains
// each choice. A warp holds neighbouring rows of one window.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 64;        // two warps a block: a small batch spreads over the SMs
constexpr int kUnroll = 4;          // steps per text prefetch (even)
constexpr int kMaxWords = 128;      // m <= 4096
constexpr int kCodes = 5;           // A, C, G, T, and N/PAD (Eq = 0)
constexpr int kFinalThreads = 256;

struct Args {
  const int32_t* peq;               // (5, W): rows 0..q-1 are words 0..ceil(q/32)-1
  const int8_t* text_t;             // (L, B)
  const int32_t* lens;              // (B,)
  unsigned long long* packed;       // (B,) (dist << 32) | uint32(end)
  int32_t* list;                    // (B,) the survivors
  int32_t* count;                   // their number
  int m, W, L, B, k;
  int q, S, overlap, windows;       // this pass
  int rows;                         // rows scored: B, or the survivors
  bool from_list;                   // pass 2: row i is list[i]
  unsigned long long none, claimed; // (m, -1), (m, -2) packed
};

__host__ __device__ inline unsigned long long pack(int dist, int end) {
  return (static_cast<unsigned long long>(dist) << 32) |
         static_cast<uint32_t>(end);
}

template <int G, int WPL>
__global__ void __launch_bounds__(kThreads)
banded_wavefront(const Args a) {
  constexpr int SL = G * WPL;                   // word slots of a group
  constexpr uint32_t kRow = 4u * SL;            // bytes of one code's Eq row
  constexpr uint32_t kRowBits = 0x3FFFFFFCu;    // the Eq row offset in a packet
  __shared__ uint32_t table[kCodes * SL];       // [code][slot]
  const int Wq = (a.q + 31) / 32;               // words of the q query rows
  const int used = (Wq + WPL - 1) / WPL;        // lanes holding words
  const int pad = used * WPL * 32 - a.q;        // neutral bits below row 0
  for (int t = threadIdx.x; t < kCodes * SL; t += kThreads) {
    const int c = t / SL;
    const int32_t* peq = a.peq + c * a.W;
    auto word = [&](int w) -> uint32_t {
      return c < 4 && w >= 0 && w < Wq ? static_cast<uint32_t>(peq[w]) : 0u;
    };
    const int r0 = (t % SL) * 32 - pad;         // query row at the slot's bit 0
    table[t] = __funnelshift_r(word(r0 >> 5), word((r0 >> 5) + 1), r0 & 31);
  }
  __syncthreads();

  const int gl = threadIdx.x & (G - 1);         // lane within the group
  const long problem = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = problem < static_cast<long>(a.rows) * a.windows;
  const int win = live ? static_cast<int>(problem / a.rows) : 0;
  const int i = live ? static_cast<int>(problem % a.rows) : 0;
  const int row = !live ? 0 : a.from_list ? a.list[i] : i;
  const int lo = win * a.S;
  const int c0 = max(0, lo - a.overlap);
  const int c1 = min(lo + a.S, a.L);
  const int n = live ? max(0, min(min(a.lens[row], a.L), c1) - c0) : 0;
  const int n_warp = __reduce_max_sync(kFull, n);
  const int tap_lane = used - 1;
  const bool lead = gl == 0;
  const uint32_t tab = gl * WPL * 4u;           // this lane's slots in the code-0 row
  const char* table_bytes = reinterpret_cast<const char*>(table);

  // lane 0 reads the text, a column a call at stride B: the Eq row offset
  // of column c0 + j's code, N past the window
  const int n_lead = lead ? n : 0;
  const size_t stride = a.B;
  const int8_t* text = a.text_t + static_cast<size_t>(c0) * stride + row;
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
  for (int w = 0; w < WPL; ++w) {
    vp[w] = kFull;
    vn[w] = 0u;
    eq_a[w] = 0u;                               // step 0 is idle everywhere
  }
  // packet from the lane below: hp top at bit 31, hn top at bit 30, the Eq
  // row offset of this lane's next column, carry at bit 0
  uint32_t in = code_row();
  int score = a.q, best = a.q, best_s = 0;

  auto step = [&](const uint32_t (&eq)[WPL], uint32_t (&eq_next)[WPL],
                  uint32_t lead_row, int s) {
    const uint32_t next_row = in & kRowBits;
    const char* src = table_bytes + tab + next_row;
#pragma unroll
    for (int w = 0; w < WPL; ++w)
      eq_next[w] = reinterpret_cast<const uint32_t*>(src)[w];
    uint32_t carry = in & 1u;
    uint32_t hp_lo = in, hn_lo = in << 1;       // bit 31: the tops from below
    uint32_t hp = 0u, hn = 0u;
#pragma unroll
    for (int w = 0; w < WPL; ++w) {
      const uint64_t sum =
          static_cast<uint64_t>(eq[w] & vp[w]) + vp[w] + carry;
      carry = static_cast<uint32_t>(sum >> 32);
      const uint32_t d0 = (static_cast<uint32_t>(sum) ^ vp[w]) | eq[w] | vn[w];
      hp = vn[w] | ~(d0 | vp[w]);
      hn = vp[w] & d0;
      const uint32_t hps = __funnelshift_l(hp_lo, hp, 1);
      const uint32_t hns = __funnelshift_l(hn_lo, hn, 1);
      hp_lo = hp;
      hn_lo = hn;
      vp[w] = hns | ~(d0 | hps);
      vn[w] = hps & d0;
    }
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

  if (gl == tap_lane && live && best <= a.k) {
    if (a.q < a.m) {                            // pass 1: the row survives
      if (atomicCAS(a.packed + row, a.none, a.claimed) == a.none)
        a.list[atomicAdd(a.count, 1)] = row;
    } else {
      const int end = best < a.q ? c0 + best_s - 1 - tap_lane : -1;
      atomicMin(a.packed + row, pack(best, end));
    }
  }
}

__global__ void banded_init(unsigned long long* packed, int32_t* count, int B,
                            unsigned long long none) {
  const int b = blockIdx.x * kFinalThreads + threadIdx.x;
  if (b < B) packed[b] = none;
  if (b == 0) *count = 0;
}

__global__ void banded_final(const unsigned long long* packed, int32_t* dist,
                             int32_t* end, int B, int m, int k) {
  const int b = blockIdx.x * kFinalThreads + threadIdx.x;
  if (b >= B) return;
  const unsigned long long v = packed[b];
  const int d = static_cast<int>(v >> 32);
  const bool ok = d <= k && d < m;
  dist[b] = ok ? d : m;
  end[b] = ok ? static_cast<int>(static_cast<uint32_t>(v)) : -1;
}

template <int G, int WPL = 1>
void launch(int wpl, const Args& a, cudaStream_t stream) {
  if constexpr (WPL < kMaxWords / G) {
    if (wpl > WPL) return launch<G, WPL + 1>(wpl, a, stream);
  }
  const long threads = static_cast<long>(a.rows) * a.windows * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  banded_wavefront<G, WPL><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// One pass of the threshold-k kernel.
// peq: (5, W) 32-bit words; text_t: (L, B) int8 codes; lens: (B,);
// dist, end: (B,) int32 outputs; packed (B,) uint64, list (B,) and count
// (1,) int32: scratch, written here. Pass 1 (rows == B) starts afresh and
// scores every row on the first q query rows (a multiple of 32, or m);
// pass 2 (q == m) scores the `rows` rows that pass 1 listed. A pass with
// q == m ends by writing dist and end. Windows: S columns owned each,
// `windows` >= ceil(L / S) of them, scored from `overlap` >= q + k - 1
// columns earlier. group: lanes per problem, 8 or 32. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int cf_myers_hw_banded(const void* peq, const void* text_t,
                                  const void* lens, void* dist, void* end,
                                  void* packed, void* list, void* count,
                                  int m, int W, int L, int B, int k,
                                  int pass, int q, int S, int overlap,
                                  int windows, int rows, int group,
                                  void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > kMaxWords || L < 0 || B < 0 ||
      k < 0 || k > m || q < 1 || q > m || (q != m && q % 32 != 0) ||
      S < 1 || windows < 1 || static_cast<long>(windows) * S < L ||
      overlap < q + k - 1 || rows < 0 || rows > B ||
      (group != 8 && group != 32) || (pass != 1 && pass != 2) ||
      (pass == 1 && rows != B) || (pass == 2 && q != m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const int32_t*>(peq),
               static_cast<const int8_t*>(text_t),
               static_cast<const int32_t*>(lens),
               static_cast<unsigned long long*>(packed),
               static_cast<int32_t*>(list), static_cast<int32_t*>(count),
               m, W, L, B, k, q, S, overlap, windows, rows, pass == 2,
               pack(m, -1), pack(m, -2)};
  const int final_blocks = (B + kFinalThreads - 1) / kFinalThreads;
  if (pass == 1)
    banded_init<<<final_blocks, kFinalThreads, 0, st>>>(a.packed, a.count, B,
                                                         a.none);
  if (rows > 0) {
    const int wpl = ((q + 31) / 32 + group - 1) / group;
    switch (group) {
      case 8: launch<8>(wpl, a, st); break;
      default: launch<32>(wpl, a, st); break;
    }
  }
  if (q == m)
    banded_final<<<final_blocks, kFinalThreads, 0, st>>>(
        a.packed, static_cast<int32_t*>(dist), static_cast<int32_t*>(end), B,
        m, k);
  return static_cast<int>(cudaGetLastError());
}
