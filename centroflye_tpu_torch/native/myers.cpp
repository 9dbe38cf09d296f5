// Myers bit-parallel edit distance + traceback (native parity engine).
//
// Original implementation of the Myers (1999) / Hyyrö (2003) bit-vector
// algorithm over 64-bit words, covering the three edlib alignment modes the
// reference relies on (NW / SHW / HW; reference edlib.h:21-47,
// myersCalcEditDistanceSemiGlobal at edlib.cpp:526). Used as the host-side
// oracle for the TPU kernel (ops/myers.py) and for fast alignment-path
// extraction (cf_align_path stores per-column vertical delta bits and walks
// them back — O(qlen*tlen/64) memory words, O((qlen+tlen)*qlen) traceback).

#include "cfnative.h"

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kWord = 64;

struct Peq {
  // bits[a * words + w] — bit i of word w set iff query[64w + i] == a
  std::vector<uint64_t> bits;
  int words;
  int qlen;
};

Peq build_peq(const int8_t* query, int32_t qlen) {
  Peq p;
  p.words = (qlen + kWord - 1) / kWord;
  p.qlen = qlen;
  p.bits.assign(5 * p.words, 0);
  for (int32_t i = 0; i < qlen; ++i) {
    int a = query[i];
    if (a >= 0 && a < 4) {
      p.bits[a * p.words + i / kWord] |= (uint64_t{1} << (i % kWord));
    }
  }
  return p;
}

// One Myers column update over all words; returns the score delta at the
// query's last row. vp/vn updated in place; optional per-column snapshots.
inline int column_update(const Peq& peq, int8_t c, bool global_mode,
                         uint64_t* vp, uint64_t* vn, int words,
                         int hw_word, int hb,
                         uint64_t* vp_col = nullptr,
                         uint64_t* vn_col = nullptr) {
  const uint64_t* eq_row = &peq.bits[(c >= 0 && c < 4 ? c : 4) * words];
  uint64_t carry_add = 0;                   // multiword addition carry
  uint64_t hp_carry = global_mode ? 1 : 0;  // bit shifted into HP
  uint64_t hn_carry = 0;
  int delta = 0;
  for (int w = 0; w < words; ++w) {
    uint64_t eq = eq_row[w];
    uint64_t pv = vp[w];
    uint64_t nv = vn[w];
    uint64_t x = eq & pv;
    uint64_t s1 = x + carry_add;
    uint64_t c0 = s1 < x;
    uint64_t s2 = s1 + pv;
    uint64_t c2 = s2 < s1;
    carry_add = c0 | c2;
    uint64_t d0 = (s2 ^ pv) | eq | nv;
    uint64_t hp = nv | ~(d0 | pv);
    uint64_t hn = pv & d0;
    if (w == hw_word) {
      if ((hp >> hb) & 1) delta = 1;
      else if ((hn >> hb) & 1) delta = -1;
    }
    uint64_t hp_sh = (hp << 1) | hp_carry;
    hp_carry = hp >> (kWord - 1);
    uint64_t hn_sh = (hn << 1) | hn_carry;
    hn_carry = hn >> (kWord - 1);
    vp[w] = hn_sh | ~(d0 | hp_sh);
    vn[w] = hp_sh & d0;
    if (vp_col) vp_col[w] = vp[w];
    if (vn_col) vn_col[w] = vn[w];
  }
  return delta;
}

}  // namespace

// ---- banded HW (threshold-k) path ----------------------------------------
//
// Ukkonen block band over the Hyyro word update: only words that can still
// hold cells <= k are computed each column (the reference recruiter's core
// speed trick, edlib.cpp:538 initial band, :598-655 adaptive extension /
// reduction — own implementation). The query is padded to a whole number
// of words with match-all rows, so the padded bottom-row score at column c
// equals the true bottom-row score at column c - pad.

namespace {

// One word update, branchless: horizontal carries ride as two bit flags
// (hp = +1 carry, hn = -1 carry). Returns the out-carries the same way.
inline void word_update2(uint64_t& P, uint64_t& M, uint64_t Eq,
                         uint64_t& hp, uint64_t& hn) {
  const uint64_t Xv = Eq | M;
  Eq |= hn;                                  // hin < 0 feeds the diagonal
  const uint64_t Xh = (((Eq & P) + P) ^ P) | Eq;
  uint64_t Ph = M | ~(Xh | P);
  uint64_t Mh = P & Xh;
  const uint64_t hp_out = Ph >> (kWord - 1);
  const uint64_t hn_out = Mh >> (kWord - 1);
  Ph = (Ph << 1) | hp;
  Mh = (Mh << 1) | hn;
  P = Mh | ~(Xv | Ph);
  M = Ph & Xv;
  hp = hp_out;
  hn = hn_out;
}

inline int word_update(uint64_t& P, uint64_t& M, uint64_t Eq, int hin) {
  uint64_t hp = hin > 0, hn = hin < 0;
  word_update2(P, M, Eq, hp, hn);
  return (int)hp - (int)hn;
}

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

// All 64 cells of a word provably > k? (bottom score + vertical deltas)
inline bool all_cells_above_k(uint64_t P, uint64_t M, int score, int k) {
  int v = score;
  if (v <= k) return false;
  for (int r = kWord - 1; r > 0; --r) {
    if ((P >> r) & 1) v -= 1;
    else if ((M >> r) & 1) v += 1;
    if (v <= k) return false;
  }
  return true;
}

int32_t hw_banded(const int8_t* query, int32_t qlen, const int8_t* target,
                  int32_t tlen, int32_t k, int32_t* end_pos) {
  const int words = (qlen + kWord - 1) / kWord;
  const int pad = words * kWord - qlen;
  if (k > qlen) k = qlen;
  // Peq with match-all padding rows (codes 0..4 all match there)
  std::vector<uint64_t> peq(5 * (size_t)words, 0);
  for (int32_t i = 0; i < qlen; ++i) {
    int a = query[i];
    if (a >= 0 && a < 4)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);
  }
  for (int32_t i = qlen; i < words * kWord; ++i)
    for (int a = 0; a < 5; ++a)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);

  int last = (k + 1 + kWord - 1) / kWord;   // blocks covering rows 0..k
  if (last > words) last = words;
  last -= 1;
  std::vector<uint64_t> P(words, ~uint64_t{0}), M(words, 0);
  std::vector<int> score(words);
  for (int b = 0; b <= last; ++b) score[b] = (b + 1) * kWord;

  constexpr int kStrongReduceEvery = 256;
  int32_t best = -1, best_j = -1;
  for (int32_t c = 0; c < tlen; ++c) {
    int a = target[c];
    if (a < 0 || a > 4) a = 4;
    const uint64_t* eq = &peq[(size_t)a * words];
    uint64_t hp = 0, hn = 0;      // HW: target prefix skip is free
    for (int b = 0; b <= last; ++b) {
      word_update2(P[b], M[b], eq[b], hp, hn);
      score[b] += (int)hp - (int)hn;
    }
    const int hout = (int)hp - (int)hn;
    // band adjustment (invariant: all cells outside [0, last] are > k)
    if (last < words - 1 && score[last] - hout <= k &&
        ((eq[last + 1] & 1) || hout < 0)) {
      ++last;
      P[last] = ~uint64_t{0};
      M[last] = 0;
      score[last] = score[last - 1] - hout + kWord;
      score[last] += word_update(P[last], M[last], eq[last], hout);
    } else {
      while (last >= 0 && score[last] >= k + kWord) --last;
    }
    if (c % kStrongReduceEvery == 0) {
      while (last >= 0 && all_cells_above_k(P[last], M[last], score[last], k))
        --last;
    }
    // HW: row 0 restarts at 0 every column — block 0 always a candidate
    if (last == -1) last = 0;

    if (last == words - 1 && c >= pad) {
      int colScore = score[last];   // true bottom row at column c - pad
      if (colScore <= k && (best == -1 || colScore < best)) {
        best = colScore;
        best_j = c - pad;
        k = best;                   // tighten: only look for improvements
      }
    }
  }
  // last `pad` true columns: walk the final column's cells upward (the
  // padded rows are diagonal copies of the true bottom row)
  if (last == words - 1 && pad > 0) {
    int v = score[last];
    for (int i = 0; i < pad; ++i) {
      int r = words * kWord - 1 - i;          // step up over row r
      int w = r / kWord, bit = r % kWord;
      if ((P[w] >> bit) & 1) v -= 1;
      else if ((M[w] >> bit) & 1) v += 1;
      int32_t pos = tlen - pad + i;
      if (pos >= 0 && v <= k && (best == -1 || v < best)) {
        best = v;
        best_j = pos;
        k = best;
      }
    }
  }
  if (end_pos) *end_pos = best_j;
  return best;   // -1 when no alignment within k exists
}

}  // namespace

// ---- banded NW (threshold-k) path ----------------------------------------
//
// Global-alignment sibling of hw_banded (role of edlib's
// myersCalcEditDistanceNW block band, edlib.cpp:707-800 — own
// implementation). Any NW cell satisfies value(i, c) >= |i - c|, so the
// band is the sliding diagonal |i - c| <= k: blocks above it drop for
// free (no bit inspection), blocks below it attach lazily exactly like
// the HW band. The query is padded to whole words with match-all rows
// and the target with `pad` match-all-only columns (code 4 matches only
// the padded rows), which forces `pad` free diagonal steps at the end:
// NW(q', t') == NW(q, t) with the answer in the padded bottom row.
// Megabase near-identical pairs (polish convergence reports) cost
// O(tlen * k / 64) words instead of the full O(tlen * qlen / 64).

namespace {

int32_t nw_banded(const int8_t* query, int32_t qlen, const int8_t* target,
                  int32_t tlen, int32_t k) {
  if (k < 0) return -1;
  if (qlen > tlen ? (qlen - tlen > k) : (tlen - qlen > k)) return -1;
  // empty-side NW is pure indels; the word machinery below assumes at
  // least one query word (qlen=0 would read score[-1])
  if (qlen == 0) return tlen <= k ? tlen : -1;
  if (tlen == 0) return qlen <= k ? qlen : -1;
  if (k > qlen + tlen) k = qlen + tlen;
  const int words = (qlen + kWord - 1) / kWord;
  const int pad = words * kWord - qlen;
  std::vector<uint64_t> peq(5 * (size_t)words, 0);
  for (int32_t i = 0; i < qlen; ++i) {
    int a = query[i];
    if (a >= 0 && a < 4)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);
  }
  for (int32_t i = qlen; i < words * kWord; ++i)
    for (int a = 0; a < 5; ++a)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);

  int first = 0;
  int last = (k + 1 + kWord - 1) / kWord;
  if (last > words) last = words;
  last -= 1;
  std::vector<uint64_t> P(words, ~uint64_t{0}), M(words, 0);
  std::vector<int> score(words);
  for (int b = 0; b <= last; ++b) score[b] = (b + 1) * kWord;

  const int32_t tpad = tlen + pad;
  for (int32_t c = 0; c < tpad; ++c) {
    int a = c < tlen ? target[c] : 4;
    if (a < 0 || a > 4) a = 4;
    const uint64_t* eq = &peq[(size_t)a * words];
    // global mode: row-0 boundary accrues +1 per column; a dropped top
    // region contributes the same worst-case +1 boundary
    uint64_t hp = 1, hn = 0;
    for (int b = first; b <= last; ++b) {
      word_update2(P[b], M[b], eq[b], hp, hn);
      score[b] += (int)hp - (int)hn;
    }
    const int hout = (int)hp - (int)hn;
    if (last < words - 1 && score[last] - hout <= k &&
        ((eq[last + 1] & 1) || hout < 0)) {
      ++last;
      P[last] = ~uint64_t{0};
      M[last] = 0;
      score[last] = score[last - 1] - hout + kWord;
      score[last] += word_update(P[last], M[last], eq[last], hout);
    } else {
      while (last >= first && score[last] >= k + kWord) --last;
    }
    // rows i <= c - k - 1 can never return to <= k (value >= c - i);
    // drop whole blocks above the sliding diagonal
    while (first <= last && (first + 1) * kWord - 1 < c - k) ++first;
    if (last < first) return -1;   // whole band > k => all later cells too
  }
  if (last != words - 1) return -1;
  return score[words - 1] <= k ? score[words - 1] : -1;
}

}  // namespace

extern "C" int32_t cf_edit_distance(const int8_t* query, int32_t qlen,
                                    const int8_t* target, int32_t tlen,
                                    int32_t mode, int32_t k,
                                    int32_t* end_pos) {
  if (qlen == 0) {
    if (end_pos) *end_pos = -1;
    // NW of an empty query is tlen deletions — which still must respect
    // a banded threshold k (ADVICE r4: this path used to ignore k)
    if (mode == CF_MODE_NW) return (k >= 0 && tlen > k) ? -1 : tlen;
    return 0;
  }
  if (mode == CF_MODE_HW && k >= 0) {
    return hw_banded(query, qlen, target, tlen, k, end_pos);
  }
  if (mode == CF_MODE_NW && k >= 0) {
    if (end_pos) *end_pos = tlen - 1;
    return nw_banded(query, qlen, target, tlen, k);
  }
  Peq peq = build_peq(query, qlen);
  int words = peq.words;
  std::vector<uint64_t> vp(words, ~uint64_t{0});
  std::vector<uint64_t> vn(words, 0);
  bool global_mode = (mode != CF_MODE_HW);
  int hw_word = (qlen - 1) / kWord;
  int hb = (qlen - 1) % kWord;
  int32_t score = qlen, best = qlen, best_j = -1;
  for (int32_t j = 0; j < tlen; ++j) {
    score += column_update(peq, target[j], global_mode, vp.data(), vn.data(),
                           words, hw_word, hb);
    if (mode != CF_MODE_NW && score < best) {
      best = score;
      best_j = j;
    }
  }
  int32_t dist = (mode == CF_MODE_NW) ? score : best;
  if (end_pos) *end_pos = (mode == CF_MODE_NW) ? tlen - 1 : best_j;
  if (k >= 0 && dist > k) return -1;
  return dist;
}

extern "C" void cf_edit_distance_batch(const int8_t* query, int32_t qlen,
                                       const int8_t* targets,
                                       const int32_t* lens, int32_t rows,
                                       int32_t stride, int32_t mode,
                                       int32_t k, int32_t* dists,
                                       int32_t* ends) {
  for (int32_t r = 0; r < rows; ++r) {
    int32_t end = -1;
    dists[r] = cf_edit_distance(query, qlen, targets + (size_t)r * stride,
                                lens[r], mode, k, &end);
    if (ends) ends[r] = end;
  }
}

namespace {

// run-length encode the reversed op string into cigar_buf
int32_t emit_cigar(const std::string& ops, char* cigar_buf, int32_t cap,
                   int32_t dist) {
  std::string cig;
  for (size_t a = ops.size(); a > 0;) {
    char op = ops[a - 1];
    size_t b = a;
    while (b > 0 && ops[b - 1] == op) --b;
    cig += std::to_string(a - b);
    cig.push_back(op);
    a = b;
  }
  if ((int32_t)cig.size() + 1 > cap) return -1;
  std::memcpy(cigar_buf, cig.c_str(), cig.size() + 1);
  return dist;
}

// Exact banded traceback: with the final distance `dist` known (from the
// cheap bit-parallel forward pass), every cell on ANY optimal path lies
// within |(jj - i) - (jj_end - qlen)| <= dist of the end-anchored
// diagonal (indels on the path suffix are bounded by its cost). Filling
// only that band gives values equal to the true DP on every cell the
// greedy walk can test (a neighbor passing `val + cost == cur` is itself
// on an optimal path, hence in-band and exact), so the emitted path is
// bit-identical to the full-matrix traceback — at O(dist * qlen) cells
// instead of O(qlen * tlen) bit-walk work. Mirrors edlib's banded design
// (reference edlib.cpp:538,598-655) but anchored for traceback.
int32_t align_path_banded(const int8_t* query, int32_t qlen,
                          const int8_t* target, int32_t /*tlen*/,
                          int32_t mode, int32_t dist, int32_t jj_end,
                          char* cigar_buf, int32_t cap,
                          int32_t* t_start, int32_t* t_end) {
  const int32_t INF = 1 << 29;
  const int64_t stride =
      std::min<int64_t>(2 * (int64_t)dist + 1, (int64_t)jj_end + 1);
  const int64_t nvals = (int64_t)(qlen + 1) * stride;
  if (nvals > (int64_t{192} << 20) / 4) return -2;  // caller falls back
  std::vector<int32_t> band((size_t)nvals, INF);
  std::vector<int32_t> lo_of(qlen + 1), hi_of(qlen + 1);
  const bool hw = (mode == CF_MODE_HW);
  for (int32_t i = 0; i <= qlen; ++i) {
    int64_t center = (int64_t)i + jj_end - qlen;
    lo_of[i] = (int32_t)std::max<int64_t>(1, center - dist);
    hi_of[i] = (int32_t)std::min<int64_t>(jj_end, center + dist);
  }
  // boundary cells (i == 0 or jj == 0) are computed on the fly
  auto getv = [&](int32_t i, int32_t jj) -> int32_t {
    if (jj == 0) return i;
    if (i == 0) return hw ? 0 : jj;
    if (jj < lo_of[i] || jj > hi_of[i]) return INF;
    return band[(size_t)i * stride + (jj - lo_of[i])];
  };
  for (int32_t i = 1; i <= qlen; ++i) {
    const int8_t qc = query[i - 1];
    int32_t* row = &band[(size_t)i * stride];
    for (int32_t jj = lo_of[i]; jj <= hi_of[i]; ++jj) {
      const int8_t tc = target[jj - 1];
      const bool match = (qc == tc && qc >= 0 && qc < 4);
      int32_t v = getv(i - 1, jj - 1) + (match ? 0 : 1);
      int32_t u = getv(i - 1, jj) + 1;
      if (u < v) v = u;
      int32_t l = getv(i, jj - 1) + 1;
      if (l < v) v = l;
      row[jj - lo_of[i]] = v;
    }
  }
  if (getv(qlen, jj_end) != dist) return -2;  // safety net: fall back

  std::string ops;
  int32_t i = qlen, jj = jj_end;
  while (i > 0) {
    if (jj == 0) {
      ops.push_back('I');
      --i;
      continue;
    }
    const int32_t cur = getv(i, jj);
    const int8_t qc = query[i - 1];
    const int8_t tc = target[jj - 1];
    const bool match = (qc == tc && qc >= 0 && qc < 4);
    if (getv(i - 1, jj - 1) + (match ? 0 : 1) == cur) {
      ops.push_back(match ? '=' : 'X');
      --i;
      --jj;
    } else if (getv(i - 1, jj) + 1 == cur) {
      ops.push_back('I');
      --i;
    } else if (getv(i, jj - 1) + 1 == cur) {
      ops.push_back('D');
      --jj;
    } else {
      return -1;
    }
  }
  if (mode == CF_MODE_NW) {
    while (jj > 0) {
      ops.push_back('D');
      --jj;
    }
  }
  if (t_start) *t_start = jj;
  if (t_end) *t_end = jj_end;
  return emit_cigar(ops, cigar_buf, cap, dist);
}

// Bit-parallel banded traceback: the production path for NW/HW PATH
// tasks (role of edlib's obtainAlignmentTraceback over banded
// AlignmentData, edlib.cpp:924-1040 — own formulation). Forward pass =
// banded Myers over a FIXED end-anchored diagonal band (every cell of
// any optimal path satisfies |(i - c) - (qlen - jj_end)| <= dist, the
// same containment the scalar band uses) storing per column the band's
// block bit-states (P, M) and block-bottom scores; traceback
// reconstructs any in-band cell value in O(1) with popcounts over the
// stored bits (value(i) = blockScore - popcnt(P & above_i) +
// popcnt(M & above_i)), so the walk costs O(path length) instead of the
// scalar band's O(qlen * dist) cell fill. Out-of-band neighbor queries
// return INF: such cells have true value > dist and can never satisfy
// the traceback equations (stored values are >= true everywhere, exact
// on every optimal-path cell — the +1-per-column boundary chain is the
// all-insert/all-delete upper bound, so in-band minima are uncorrupted;
// see the scalar version's proof sketch above). Emitted cigars are
// bit-identical to the scalar/full tracebacks (same move preference:
// diagonal, up, left).
namespace {

int32_t align_path_myers(const int8_t* query, int32_t qlen,
                         const int8_t* target, int32_t /*tlen*/,
                         int32_t mode, int32_t dist, int32_t jj_end,
                         char* cigar_buf, int32_t cap,
                         int32_t* t_start, int32_t* t_end) {
  if (qlen <= 0 || jj_end <= 0) return -2;
  const int words = (qlen + kWord - 1) / kWord;
  const int W = std::min<int64_t>(words, 2 * ((int64_t)dist / kWord) + 3);
  if ((int64_t)jj_end * W > (int64_t{128} << 20) / 20) return -2;
  const bool hw = (mode == CF_MODE_HW);
  // match-all padded query rows (no target padding: values are read at
  // real rows via popcount peeling)
  std::vector<uint64_t> peq(5 * (size_t)words, 0);
  for (int32_t i = 0; i < qlen; ++i) {
    int a = query[i];
    if (a >= 0 && a < 4)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);
  }
  for (int32_t i = qlen; i < words * kWord; ++i)
    for (int a = 0; a < 5; ++a)
      peq[(size_t)a * words + i / kWord] |= uint64_t{1} << (i % kWord);

  const int64_t anchor = (int64_t)qlen - jj_end;  // i - c on the end diagonal
  auto bf_of = [&](int32_t c) -> int {
    int64_t lo = (int64_t)c + anchor - dist;
    if (lo <= 0) return 0;
    return (int)std::min<int64_t>(lo / kWord, words - 1);
  };
  auto bl_of = [&](int32_t c) -> int {
    int64_t hi = (int64_t)c + anchor + dist;
    if (hi < 0) return -1;                        // band not entered yet
    return (int)std::min<int64_t>(hi / kWord, words - 1);
  };

  std::vector<uint64_t> Ps((size_t)jj_end * W), Ms((size_t)jj_end * W);
  std::vector<int32_t> Bs((size_t)jj_end * W);
  std::vector<int32_t> bfs(jj_end), bls(jj_end);

  std::vector<uint64_t> P(words), M(words);
  std::vector<int32_t> score(words);
  int cur_bl = -2;                                // -2: nothing live yet
  for (int32_t c = 0; c < jj_end; ++c) {
    const int bf = bf_of(c), bl = bl_of(c);
    bfs[c] = bf;
    bls[c] = bl;
    if (bl < 0) { cur_bl = -2; continue; }
    if (cur_bl < -1 || bf > cur_bl) {
      // (re)enter: initialize the whole range to the column boundary
      // state D(i, c-1) ~ i+1 (the >=-true all-insert bound)
      for (int b = bf; b <= bl; ++b) {
        P[b] = ~uint64_t{0};
        M[b] = 0;
        score[b] = (b + 1) * kWord;
      }
    } else if (bl > cur_bl) {
      for (int b = cur_bl + 1; b <= bl; ++b) {    // attach below
        P[b] = ~uint64_t{0};
        M[b] = 0;
        score[b] = score[b - 1] + kWord;
      }
    }
    cur_bl = bl;
    const int a0 = (target[c] >= 0 && target[c] <= 4) ? target[c] : 4;
    const uint64_t* eq = &peq[(size_t)a0 * words];
    // top boundary: row -1 is 0 for HW (free prefix skip) and c+1 for
    // NW; a dropped top region feeds the +1-per-column worst case
    uint64_t hp = (hw && bf == 0) ? 0 : 1, hn = 0;
    for (int b = bf; b <= bl; ++b) {
      word_update2(P[b], M[b], eq[b], hp, hn);
      score[b] += (int)hp - (int)hn;
    }
    uint64_t* pc = &Ps[(size_t)c * W];
    uint64_t* mc = &Ms[(size_t)c * W];
    int32_t* bc = &Bs[(size_t)c * W];
    for (int b = bf; b <= bl; ++b) {
      pc[b - bf] = P[b];
      mc[b - bf] = M[b];
      bc[b - bf] = score[b];
    }
  }

  const int32_t INF = 1 << 29;
  auto value_at = [&](int32_t i, int32_t c) -> int32_t {
    // D(i, c) with 0-based i/c; boundaries: D(i, -1) = i + 1,
    // D(-1, c) = hw ? 0 : c + 1
    if (i < 0) return hw ? 0 : c + 1;
    if (c < 0) return i + 1;
    const int b = i / kWord;
    if (b < bfs[c] || b > bls[c]) return INF;
    const size_t off = (size_t)c * W + (b - bfs[c]);
    int32_t v = Bs[off];
    const int bit = i % kWord;
    if (bit != kWord - 1) {
      const uint64_t above = ~uint64_t{0} << (bit + 1);
      v -= popcount64(Ps[off] & above);
      v += popcount64(Ms[off] & above);
    }
    return v;
  };

  if (value_at(qlen - 1, jj_end - 1) != dist) return -2;  // safety net

  std::string ops;
  int32_t i = qlen - 1, c = jj_end - 1;
  int32_t cur = dist;
  while (i >= 0) {
    if (c < 0) {                  // target exhausted: rest is 'I'
      ops.push_back('I');
      --i;
      continue;
    }
    const int8_t qc = query[i];
    const int8_t tc = target[c];
    const bool match = (qc == tc && qc >= 0 && qc < 4);
    const int32_t diag = value_at(i - 1, c - 1);
    if (diag + (match ? 0 : 1) == cur) {
      ops.push_back(match ? '=' : 'X');
      --i;
      --c;
      cur = diag;
      if (i < 0 && hw) break;     // HW: top row reached, done
      continue;
    }
    const int32_t up = value_at(i - 1, c);
    if (up + 1 == cur) {
      ops.push_back('I');
      --i;
      cur = up;
      continue;
    }
    const int32_t left = value_at(i, c - 1);
    if (left + 1 == cur) {
      ops.push_back('D');
      --c;
      cur = left;
      continue;
    }
    return -2;                    // inconsistent: scalar fallback
  }
  if (mode == CF_MODE_NW) {
    while (c >= 0) {
      ops.push_back('D');
      --c;
    }
  }
  if (t_start) *t_start = c + 1;
  if (t_end) *t_end = jj_end;
  return emit_cigar(ops, cigar_buf, cap, dist);
}

}  // namespace

// full-matrix fallback: per-column vertical delta snapshots + bit walks
// (O(qlen*tlen/64) memory words, unbounded band)
int32_t align_path_full(const int8_t* query, int32_t qlen,
                        const int8_t* target, int32_t tlen,
                        int32_t mode, char* cigar_buf, int32_t cap,
                        int32_t* t_start, int32_t* t_end) {
  Peq peq = build_peq(query, qlen);
  int words = peq.words;
  std::vector<uint64_t> vp(words, ~uint64_t{0});
  std::vector<uint64_t> vn(words, 0);
  bool global_mode = (mode != CF_MODE_HW);
  int hw_word = (qlen - 1) / kWord;
  int hb = (qlen - 1) % kWord;
  // per-column vertical delta snapshots + bottom-row scores for traceback
  std::vector<uint64_t> vp_cols((size_t)tlen * words);
  std::vector<uint64_t> vn_cols((size_t)tlen * words);
  std::vector<int32_t> bottom(tlen);
  int32_t score = qlen, best = qlen, best_j = -1;
  for (int32_t j = 0; j < tlen; ++j) {
    score += column_update(peq, target[j], global_mode, vp.data(), vn.data(),
                           words, hw_word, hb,
                           &vp_cols[(size_t)j * words],
                           &vn_cols[(size_t)j * words]);
    bottom[j] = score;
    if (mode != CF_MODE_NW && score < best) {
      best = score;  // first best column (parity with the TPU kernel)
      best_j = j;
    }
  }
  int32_t dist;
  int32_t j_end;
  if (mode == CF_MODE_NW) {
    dist = score;
    j_end = tlen - 1;
  } else {
    dist = best;
    j_end = best_j;
    if (j_end < 0) {  // empty alignment is best: no path to emit
      if (t_start) *t_start = 0;
      if (t_end) *t_end = 0;
      if (cap > 0) cigar_buf[0] = '\0';
      return dist;
    }
  }
  if (t_end) *t_end = j_end + 1;

  auto cell = [&](int32_t i, int32_t j) -> int64_t {
    // D(i, j); column -1 is the left boundary (D = i in all modes)
    if (j < 0) return i;
    int64_t v = bottom[j];
    const uint64_t* vpc = &vp_cols[(size_t)j * words];
    const uint64_t* vnc = &vn_cols[(size_t)j * words];
    for (int32_t r = qlen - 1; r >= i; --r) {
      uint64_t bit = uint64_t{1} << (r % kWord);
      if (vpc[r / kWord] & bit) v -= 1;
      else if (vnc[r / kWord] & bit) v += 1;
    }
    return v;
  };

  std::string ops;
  int32_t i = qlen, j = j_end;
  while (i > 0) {
    if (j < 0) {
      ops.push_back('I');
      --i;
      continue;
    }
    int64_t cur = cell(i, j);
    int8_t qc = query[i - 1];
    int8_t tc = target[j];
    bool match = (qc == tc && qc >= 0 && qc < 4);
    if (cell(i - 1, j - 1) + (match ? 0 : 1) == cur) {
      ops.push_back(match ? '=' : 'X');
      --i;
      --j;
    } else if (cell(i - 1, j) + 1 == cur) {
      ops.push_back('I');
      --i;
    } else if (cell(i, j - 1) + 1 == cur) {
      ops.push_back('D');
      --j;
    } else {
      return -1;  // inconsistent — should not happen
    }
  }
  if (mode == CF_MODE_NW) {
    while (j >= 0) {
      ops.push_back('D');
      --j;
    }
  }
  if (t_start) *t_start = j + 1;

  return emit_cigar(ops, cigar_buf, cap, dist);
}

}  // namespace

extern "C" int32_t cf_align_path(const int8_t* query, int32_t qlen,
                                 const int8_t* target, int32_t tlen,
                                 int32_t mode, char* cigar_buf, int32_t cap,
                                 int32_t* t_start, int32_t* t_end) {
  if (qlen == 0 || tlen == 0) return -1;
  // pass 1: bit-parallel distance + end column (no snapshots). NW/HW go
  // through the banded engines with a doubling threshold (edlib's
  // band-doubling strategy, edlib.cpp:175 — own formulation): the
  // polish workloads align near-identical ~2 kb pairs whose distance is
  // a few percent of the length, so the first or second band attempt
  // succeeds at a fraction of the full O(qlen/64 * tlen) column work.
  int32_t end_j = -1;
  int32_t dist = -1;
  if (mode == CF_MODE_NW || mode == CF_MODE_HW) {
    int32_t diff = qlen > tlen ? qlen - tlen : tlen - qlen;
    int32_t k = std::max(int32_t{64}, mode == CF_MODE_NW ? 2 * diff : 0);
    for (;; k *= 4) {
      if (k >= qlen) { k = -1; }   // band covers everything: plain pass
      dist = cf_edit_distance(query, qlen, target, tlen, mode, k, &end_j);
      if (dist >= 0 || k < 0) break;
    }
    // unbanded HW encodes "empty alignment is best" as end_j = -1 when
    // nothing beats qlen; the banded engine reports such a column
    // explicitly — normalize so both entry paths agree
    if (mode == CF_MODE_HW && dist >= qlen) { dist = qlen; end_j = -1; }
  } else {
    dist = cf_edit_distance(query, qlen, target, tlen, mode, -1, &end_j);
  }
  if (mode != CF_MODE_NW && end_j < 0) {  // empty alignment is best
    if (t_start) *t_start = 0;
    if (t_end) *t_end = 0;
    if (cap > 0) cigar_buf[0] = '\0';
    return dist;
  }
  const int32_t jj_end = (mode == CF_MODE_NW) ? tlen : end_j + 1;
  // pass 2: bit-parallel banded traceback (exact; band from the known
  // distance); scalar band and full matrix remain as safety fallbacks
  int32_t r = align_path_myers(query, qlen, target, tlen, mode, dist,
                               jj_end, cigar_buf, cap, t_start, t_end);
  if (r != -2) return r;
  r = align_path_banded(query, qlen, target, tlen, mode, dist,
                        jj_end, cigar_buf, cap, t_start, t_end);
  if (r != -2) return r;
  return align_path_full(query, qlen, target, tlen, mode, cigar_buf, cap,
                         t_start, t_end);
}

// ---- batched traceback against a shared target ---------------------------
//
// The polisher's inner loop: thousands of read-segment vs template
// alignments per stage (the role the reference fills with one external
// `flye --polish-target` process per position, eltr_polisher.py:99-114).
// Native thread fan-out over pairs — the runtime counterpart of the
// reference's xargs -P process parallelism (run_read_recruitment.sh:42).

#include <thread>
#include <atomic>

extern "C" void cf_align_path_batch(const int8_t* queries,
                                    const int32_t* qlens, int32_t n,
                                    int64_t stride, const int8_t* target,
                                    int32_t tlen, int32_t mode,
                                    int32_t threads, int32_t* dists,
                                    int32_t* t_starts, int32_t* t_ends,
                                    char* cigar_buf, int64_t cigar_cap) {
  if (threads <= 0) {
    threads = (int32_t)std::thread::hardware_concurrency();
    if (threads <= 0) threads = 1;
  }
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t ts = 0, te = 0;
      int32_t d = cf_align_path(queries + (size_t)i * stride, qlens[i],
                                target, tlen, mode,
                                cigar_buf + (size_t)i * cigar_cap,
                                (int32_t)cigar_cap, &ts, &te);
      dists[i] = d;
      t_starts[i] = ts;
      t_ends[i] = te;
    }
  };
  if (threads == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

extern "C" void cf_align_path_pairs(const int8_t* queries,
                                    const int32_t* qlens, int64_t qstride,
                                    const int8_t* targets,
                                    const int32_t* tlens, int64_t tstride,
                                    int32_t n, int32_t mode,
                                    int32_t threads, int32_t* dists,
                                    int32_t* t_starts, int32_t* t_ends,
                                    char* cigar_buf, int64_t cigar_cap) {
  if (threads <= 0) {
    threads = (int32_t)std::thread::hardware_concurrency();
    if (threads <= 0) threads = 1;
  }
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t ts = 0, te = 0;
      int32_t d = cf_align_path(queries + (size_t)i * qstride, qlens[i],
                                targets + (size_t)i * tstride, tlens[i],
                                mode, cigar_buf + (size_t)i * cigar_cap,
                                (int32_t)cigar_cap, &ts, &te);
      dists[i] = d;
      t_starts[i] = ts;
      t_ends[i] = te;
    }
  };
  if (threads == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}
