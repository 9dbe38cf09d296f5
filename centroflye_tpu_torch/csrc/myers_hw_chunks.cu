// Two-strand HW (infix) Myers for the fused recruitment step's survivors,
// in exact column chunks, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's fused step scores its first
// k_budget compacted rows whole with myers_hw_pallas_v3_2strand (K1 here,
// csrc/myers_hw_2strand.cu). This kernel returns the same distances, bit
// for bit, for the rows that passed the seed filter, and does no work on
// the rows that failed.
//
// What bounds it: the length of one warp's serial sweep. K1 gives each
// (row, strand) one warp (G = 32 at the fused step's 128 rows); a warp
// steps a column at a time, about 89 ns a column on DXZ1, so a 32,768-
// column row takes about 2.9 ms however few rows there are, and the card
// sits nearly empty. Here each passing row is cut into chunks of C columns
// that run side by side, one warp a (row, chunk, strand): a launch takes
// about one chunk's sweep, C plus a warm-up of 2m - 1 columns, while the
// chunks fit the card at once, and the warm-up is the work it adds.
//
// Why a chunk is exact: under HW a cell D[i][j] is at most i (the query's
// first i rows against no text), and an alignment of cost at most m spans
// at most 2m text columns. So the score of row m at column j is reached by
// an alignment that starts at or after column j - 2m + 1, and a sweep
// started afresh at column s <= c0 - (2m - 1) holds the exact score at
// every column from c0 on. A fresh start only constrains the alignment,
// so every column of the warm-up scores at or above its true value. The
// minimum over the chunks (each owning [c0, c0 + C) of the row) is the
// whole row's HW distance; a row of n <= C + 2m - 1 columns is one chunk,
// K1's sweep. Chunk starts are rounded down to a multiple of 16 columns
// (more warm-up, still exact), so a chunk reads whole mask bytes.
//
// The chunk width follows the passing rows, read on the card: the least
// of C, 2C, 4C, ... whose (row, chunk) pairs number at most the grid's
// blocks, or that cuts a row into two. Few rows take narrow chunks (the
// sweep is short and the card holds them all); many rows take wide ones
// (less warm-up where the card is full anyway). The grid is fixed by the
// card (the wrapper launches 2 blocks an SM, the fastest of 1 to 6 on the
// H100), and each block sweeps pairs p = blockIdx.x, + gridDim.x, ... in
// turn, so the blocks with work are spread evenly over the SMs.
//
// Inputs are the fused step's own device arrays, so that the host neither
// waits nor copies: the 2-bit packed rows (base j at bits 2(j % 4) of byte
// j / 4), the N mask when the batch has one (flag j at bit j % 8 of byte
// j / 8), lens, the pass order `top` (the passing rows first) and n_pass.
// Pair p is chunk p % chunks of row top[p / chunks], one warp a strand; a
// block with no pair exits before it builds its table. Each warp's
// minimum lowers dist_f[row] or dist_r[row] by atomicMin (they start at
// m), so the pairs' order does not matter and the result is the same
// every run.
//
// The step loop is myers_hw_2strand.cu's with G = 32 (that file's header
// explains each choice): lane l of a warp holds word slots
// [l*WPL, (l+1)*WPL) of the query stored at the top of the used lanes'
// bits, Eq comes from a shared-memory table by slot, lane 0 reads the text
// a column a step ahead and feeds N past the chunk's end, and one
// __shfl_up_sync of a packed word moves the carry, the top bits of hp and
// hn and the next column's Eq row one lane a step. Only the distance is
// kept: the fused step's bundle has no end column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kG = 32;              // lanes a (row, chunk, strand): one warp
constexpr int kThreads = 2 * kG;    // a block: a (row, chunk) pair's strands
constexpr int kUnroll = 4;          // steps per text prefetch (even)
constexpr int kMaxWords = 128;      // m <= 4096
constexpr int kCodes = 5;           // A, C, G, T, and N/PAD (Eq = 0)
constexpr int kAlign = 16;          // chunk starts: whole mask bytes

struct Args {
  const int32_t* peq_f;             // (5, W)
  const int32_t* peq_r;             // (5, W)
  const uint8_t* packed;            // (B, Lq): 4 bases a byte
  const uint8_t* n_mask;            // (B, Lq / 2): 8 N flags a byte, or null
  const int32_t* lens;              // (B,)
  const int64_t* top;               // (K,): rows in pass order
  const int32_t* n_pass;            // (1,): rows that passed
  int32_t* dist_f;                  // (B,): lowered, never raised
  int32_t* dist_r;                  // (B,)
  int m, W, Lq, B, K, C;
  bool fixed;                       // C as given: no widening
};

// chunks of a row of n columns at chunk width C
__device__ __forceinline__ int n_chunks(int n, int C, int warm) {
  return n <= C + warm ? 1 : (n + C - 1) / C;
}

template <int WPL>
__global__ void __launch_bounds__(kThreads)
myers_hw_wavefront_chunks(const Args a) {
  constexpr int S = kG * WPL;                   // word slots of a warp
  constexpr uint32_t kRow = 4u * S;             // bytes of one code's Eq row
  constexpr uint32_t kRowBits = 0x3FFFFFFCu;    // the Eq row offset in a packet
  __shared__ uint32_t table[2 * kCodes * S];    // [strand][code][slot]

  // the chunk width: the least of C, 2C, 4C, ... whose (row, chunk) pairs
  // fit the grid at one a block, or that cuts a row into two chunks
  const int rows = min(*a.n_pass, a.K);
  const int L = 4 * a.Lq;
  const int warm = 2 * a.m - 1;
  int C = a.C;
  while (!a.fixed && rows * n_chunks(L, C, warm) > static_cast<int>(gridDim.x)
         && n_chunks(L, C, warm) > 2)
    C *= 2;
  const int chunks = n_chunks(L, C, warm);
  const int pairs = rows * chunks;
  if (static_cast<int>(blockIdx.x) >= pairs) return;  // no work: no table

  const int used = (a.W + WPL - 1) / WPL;       // lanes holding words
  const int pad = used * WPL * 32 - a.m;        // neutral bits below row 0
  for (int k = threadIdx.x; k < 2 * kCodes * S; k += kThreads) {
    const int s = k / (kCodes * S), c = (k / S) % kCodes;
    const int32_t* peq = (s ? a.peq_r : a.peq_f) + c * a.W;
    auto word = [&](int w) -> uint32_t {
      return c < 4 && w >= 0 && w < a.W ? static_cast<uint32_t>(peq[w]) : 0u;
    };
    const int r0 = (k % S) * 32 - pad;          // query row at the slot's bit 0
    table[k] = __funnelshift_r(word(r0 >> 5), word((r0 >> 5) + 1), r0 & 31);
  }
  __syncthreads();

  const int gl = threadIdx.x & (kG - 1);        // lane within the warp
  const int strand = threadIdx.x / kG;
  const int tap_lane = used - 1;
  const bool lead = gl == 0;
  // byte offset of this lane's slots in the code-0 row of its strand
  const uint32_t tab = (strand * kCodes * S + gl * WPL) * 4u;
  const char* table_bytes = reinterpret_cast<const char*>(table);

  // the block's pairs: p = blockIdx.x, + gridDim.x, ...; pair p is chunk
  // q = p % chunks of row top[p / chunks]
  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int row = static_cast<int>(a.top[p / chunks]);
    const int n = max(0, min(a.lens[row], L));
    const int lo = (p % chunks) * C;            // the chunk owns [lo, lo + C)
    int c0 = 0, c1 = 0;                         // the columns swept
    if (n > C + warm && lo < n) {
      c0 = max(0, lo - warm) / kAlign * kAlign;
      c1 = min(n, lo + C);
    } else if (lo == 0) {
      c1 = n;                                   // one chunk: K1's sweep
    }
    if (c1 <= c0) continue;                     // past the row, or empty: m

    // lane 0 reads the chunk's columns from the packed row, a column a call:
    // the Eq row offset of column c0 + j's code, N where masked and past c1
    const int n_lead = lead ? c1 - c0 : 0;
    const uint8_t* text = a.packed + static_cast<size_t>(row) * a.Lq + c0 / 4;
    const uint8_t* mask = a.n_mask == nullptr ? nullptr
        : a.n_mask + static_cast<size_t>(row) * (a.Lq / 2) + c0 / 8;
    int j = 0;
    auto code_row = [&]() -> uint32_t {
      uint32_t r = 4u * kRow;
      if (j < n_lead) {
        r = ((text[j >> 2] >> (2 * (j & 3))) & 3u) * kRow;
        if (mask != nullptr && ((mask[j >> 3] >> (j & 7)) & 1u)) r = 4u * kRow;
      }
      ++j;
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
    // row offset of this lane's next column, carry at bit 0; lane 0's holds
    // column c0's row and nothing else
    uint32_t in = code_row();                     // lanes but 0: N
    int score = a.m, best = a.m;

    auto step = [&](const uint32_t (&eq)[WPL], uint32_t (&eq_next)[WPL],
                    uint32_t lead_row) {
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
      in = __shfl_up_sync(kFull, out, 1);
      if (lead) in = lead_row;                    // HW: nothing enters row 0
      score += static_cast<int>(hp >> 31) - static_cast<int>(hn >> 31);
      best = min(best, score);
    };

    uint32_t ahead[kUnroll];                      // lane 0: rows of columns s+1..
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ahead[u] = code_row();
    const int steps = c1 - c0 + tap_lane + 1;
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      uint32_t later[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) later[u] = code_row();
#pragma unroll
      for (int u = 0; u < kUnroll; u += 2) {     // Eq buffers swap, not copied
        step(eq_a, eq_b, ahead[u]);
        step(eq_b, eq_a, ahead[u + 1]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ahead[u] = later[u];
    }
    if (gl == tap_lane) atomicMin((strand ? a.dist_r : a.dist_f) + row, best);
  }
}

template <int WPL = 1>
void launch(int wpl, int blocks, const Args& a, cudaStream_t stream) {
  if constexpr (WPL < kMaxWords / kG) {
    if (wpl > WPL) return launch<WPL + 1>(wpl, blocks, a, stream);
  }
  myers_hw_wavefront_chunks<WPL><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// peq_f, peq_r: (5, W) 32-bit words; packed: (B, Lq) uint8 rows; n_mask:
// (B, Lq / 2) uint8 or null; lens: (B,) int32; top: (K,) int64 row
// indices, the passing rows first; n_pass: (1,) int32 on the card.
// dist_f, dist_r: (B,) int32, lowered in place to each scored row's HW
// distance (callers set them to m first). C: the chunk width (a multiple
// of 16), the least one unless `fixed`; blocks: the grid, 64 threads a
// block, each block sweeping (row, chunk) pairs in turn. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() (0 on success).
extern "C" int cf_myers_hw_chunks(const void* peq_f, const void* peq_r,
                                  const void* packed, const void* n_mask,
                                  const void* lens, const void* top,
                                  const void* n_pass, void* dist_f,
                                  void* dist_r, int m, int W, int Lq, int B,
                                  int K, int C, int fixed, int blocks,
                                  void* stream) {
  if (m < 1 || W != (m + 31) / 32 || W > kMaxWords || Lq < 0 || Lq % 2 ||
      Lq > (1 << 28) || B < 0 || K < 0 || K > B || C < kAlign ||
      C % kAlign || blocks < 1 ||
      static_cast<long>(K) * ((4L * Lq + C - 1) / C) > 0x7FFFFFFFL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  const Args a{static_cast<const int32_t*>(peq_f),
               static_cast<const int32_t*>(peq_r),
               static_cast<const uint8_t*>(packed),
               static_cast<const uint8_t*>(n_mask),
               static_cast<const int32_t*>(lens),
               static_cast<const int64_t*>(top),
               static_cast<const int32_t*>(n_pass),
               static_cast<int32_t*>(dist_f), static_cast<int32_t*>(dist_r),
               m, W, Lq, B, K, C, fixed != 0};
  launch((W + kG - 1) / kG, blocks, a, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
