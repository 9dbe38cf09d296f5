// Streaming FASTA/FASTQ(.gz) reader with inline 2-bit packing.
//
// The native data-loader of the engine — the role kseq.h plays for the
// reference's rr recruiter (reference rr.cpp:8,73). Original implementation:
// buffered zlib stream -> record state machine -> int8 base codes
// (A=0 C=1 G=2 T=3, other=4) written straight into caller buffers that are
// ready for device upload (no intermediate string copies).

#include "cfnative.h"

#include <zlib.h>

#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr size_t kBufSize = 1 << 20;

int8_t g_code[256];
bool g_code_init = false;

void init_codes() {
  if (g_code_init) return;
  for (int i = 0; i < 256; ++i) g_code[i] = 4;
  g_code['A'] = g_code['a'] = 0;
  g_code['C'] = g_code['c'] = 1;
  g_code['G'] = g_code['g'] = 2;
  g_code['T'] = g_code['t'] = 3;
  g_code_init = true;
}

}  // namespace

struct cf_reader {
  gzFile gz = nullptr;
  std::vector<unsigned char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  bool fastq = false;
  bool format_known = false;

  int peek() {
    if (pos >= len) {
      if (eof) return -1;
      len = gzread(gz, buf.data(), (unsigned)buf.size());
      pos = 0;
      if ((int)len <= 0) {
        eof = true;
        len = 0;
        return -1;
      }
    }
    return buf[pos];
  }
  int get() {
    int c = peek();
    if (c >= 0) ++pos;
    return c;
  }
  void skip_line() {
    int c;
    while ((c = get()) >= 0 && c != '\n') {
    }
  }
};

extern "C" cf_reader* cf_reader_open(const char* path) {
  init_codes();
  gzFile gz = gzopen(path, "rb");
  if (!gz) return nullptr;
  gzbuffer(gz, 1 << 20);
  cf_reader* r = new cf_reader();
  r->gz = gz;
  r->buf.resize(kBufSize);
  return r;
}

extern "C" void cf_reader_close(cf_reader* r) {
  if (!r) return;
  if (r->gz) gzclose(r->gz);
  delete r;
}

extern "C" int64_t cf_reader_next(cf_reader* r, int8_t* codes_buf,
                                  int64_t cap, char* id_buf,
                                  int32_t id_cap) {
  // find next header
  int c;
  while ((c = r->peek()) >= 0 && c != '>' && c != '@') r->skip_line();
  if (c < 0) return -1;
  if (!r->format_known) {
    r->fastq = (c == '@');
    r->format_known = true;
  }
  r->get();  // consume marker
  // id = token up to whitespace; rest of header skipped
  int32_t id_len = 0;
  bool in_id = true;
  while ((c = r->get()) >= 0 && c != '\n') {
    if (in_id) {
      if (c == ' ' || c == '\t' || c == '\r') {
        in_id = false;
      } else if (id_len + 1 < id_cap) {
        id_buf[id_len++] = (char)c;
      } else {
        return -3;  // id overflow: treat as parse error
      }
    }
  }
  id_buf[id_len] = '\0';

  int64_t n = 0;
  if (r->fastq) {
    // one sequence line (multi-line FASTQ is nonstandard)
    while ((c = r->get()) >= 0 && c != '\n') {
      if (c == '\r') continue;
      if (n >= cap) return -2;
      codes_buf[n++] = g_code[(unsigned char)c];
    }
    r->skip_line();  // '+'
    // qualities: exactly n chars (may span buffer loads)
    int64_t q = 0;
    while (q < n && (c = r->get()) >= 0) {
      if (c != '\n' && c != '\r') ++q;
    }
    // trailing newline of quality line
    while ((c = r->peek()) >= 0 && (c == '\n' || c == '\r')) r->get();
  } else {
    while ((c = r->peek()) >= 0 && c != '>') {
      c = r->get();
      if (c == '\n' || c == '\r') continue;
      if (n >= cap) return -2;
      codes_buf[n++] = g_code[(unsigned char)c];
    }
  }
  return n;
}

// ---- batch 2-bit packing -------------------------------------------------
//
// Single-pass packer for device upload (the host-side counterpart of the
// fused recruitment step's packed transfer, ops/fused_recruit.py). One
// linear scan, no temporaries: immune to the allocation/page-fault churn
// that makes the multi-pass numpy fallback erratic on busy hosts.

extern "C" int32_t cf_pack2bit(const int8_t* codes, int64_t rows,
                               int64_t len, const int32_t* lens,
                               uint8_t* packed, uint8_t* n_mask) {
  if (len % 8 != 0) return -1;
  const int64_t qwords = len / 8;
  int32_t any_n = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int8_t* row = codes + r * len;
    uint8_t* prow = packed + r * (len / 4);
    uint8_t* mrow = n_mask + r * qwords;
    const int64_t rlen = lens ? lens[r] : len;
    for (int64_t q = 0; q < qwords; ++q) {
      uint8_t p0 = 0, p1 = 0, mask = 0;
      const int8_t* c = row + q * 8;
      const int64_t base = q * 8;
      for (int b = 0; b < 4; ++b) {
        int8_t v = c[b];
        if (v >= 4 || v < 0) {
          if (base + b < rlen) mask |= (uint8_t)(1u << b);
          v = 0;
        }
        p0 |= (uint8_t)(v << (2 * b));
      }
      for (int b = 4; b < 8; ++b) {
        int8_t v = c[b];
        if (v >= 4 || v < 0) {
          if (base + b < rlen) mask |= (uint8_t)(1u << b);
          v = 0;
        }
        p1 |= (uint8_t)(v << (2 * (b - 4)));
      }
      prow[2 * q] = p0;
      prow[2 * q + 1] = p1;
      mrow[q] = mask;
      any_n |= (mask != 0);
    }
  }
  return any_n;
}

// Pack ASCII bases seq[start : start+len] straight into one 2-bit packed
// row (out_bytes wide, zero-filled past len) — encode + pad + pack in a
// single scan, no intermediate code array. Bases A/C/G/T (either case)
// pack as 0..3; anything else packs as 0 and sets the return flag so the
// caller can route the row to the exact (mask-aware) tier. The streaming
// engine's hot fill path (stages/recruitment.py): one call per segment row.
extern "C" int32_t cf_encode_pack_row(const char* seq, int64_t start,
                                      int64_t len, uint8_t* out,
                                      int64_t out_bytes) {
  init_codes();
  const char* s = seq + start;
  int32_t any_n = 0;
  int64_t q = 0;
  const int64_t full_q = len / 4;
  if (full_q > out_bytes) return -1;
  for (; q < full_q; ++q) {
    uint8_t p = 0;
    for (int b = 0; b < 4; ++b) {
      int8_t v = g_code[(unsigned char)s[4 * q + b]];
      if (v > 3) { any_n = 1; v = 0; }
      p |= (uint8_t)(v << (2 * b));
    }
    out[q] = p;
  }
  if (q < out_bytes) {
    uint8_t p = 0;
    int b = 0;
    for (int64_t i = 4 * q; i < len; ++i, ++b) {
      int8_t v = g_code[(unsigned char)s[i]];
      if (v > 3) { any_n = 1; v = 0; }
      p |= (uint8_t)(v << (2 * b));
    }
    out[q++] = p;
    for (; q < out_bytes; ++q) out[q] = 0;
  }
  return any_n;
}
