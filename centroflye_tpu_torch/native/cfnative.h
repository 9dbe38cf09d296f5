/* centroflye_tpu native runtime — C API.
 *
 * Native counterparts of the reference's C/C++ inventory
 * (reference scripts/read_recruitment/: rr.cpp + vendored edlib + kseq):
 *  - a streaming gzip FASTA/FASTQ reader with inline 2-bit packing
 *    (the data-loader role of kseq.h), and
 *  - a 64-bit-word Myers bit-parallel edit-distance engine with optional
 *    traceback (the edlib role) used for host-side parity checks of the
 *    TPU kernel and for alignment-path extraction.
 * Both are original implementations designed around this engine's data
 * model (int8 base codes, batch buffers ready for device upload).
 */

#ifndef CFNATIVE_H_
#define CFNATIVE_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- alignment ---------------------------------------------------- */

/* modes */
#define CF_MODE_NW 0   /* global */
#define CF_MODE_SHW 1  /* prefix: anchored start, free end */
#define CF_MODE_HW 2   /* infix: free start and end */

/* Edit distance of query vs target over int8 base codes (0..3; >=4 never
 * matches). k >= 0 enables banded early-out: returns -1 if distance > k.
 * end_pos (nullable): 0-based index of last aligned target char (first
 * column achieving the min), or -1. Returns the distance, or -1. */
int32_t cf_edit_distance(const int8_t* query, int32_t qlen,
                         const int8_t* target, int32_t tlen,
                         int32_t mode, int32_t k, int32_t* end_pos);

/* Batch distance over a padded row-major (rows x stride) code matrix.
 * lens[r] gives each row's true length. Writes dists[r] and ends[r]. */
void cf_edit_distance_batch(const int8_t* query, int32_t qlen,
                            const int8_t* targets, const int32_t* lens,
                            int32_t rows, int32_t stride,
                            int32_t mode, int32_t k,
                            int32_t* dists, int32_t* ends);

/* Full alignment with traceback. Writes an extended-cigar string
 * ('=', 'X', 'I' = extra query char, 'D' = extra target char) into
 * cigar_buf (cap bytes incl. NUL). t_start/t_end: target span.
 * Returns distance, or -1 on failure/overflow. */
int32_t cf_align_path(const int8_t* query, int32_t qlen,
                      const int8_t* target, int32_t tlen,
                      int32_t mode,
                      char* cigar_buf, int32_t cap,
                      int32_t* t_start, int32_t* t_end);

/* Batch alignment-with-traceback against ONE shared target: queries is a
 * padded row-major (n x stride) code matrix, qlens the true lengths.
 * Writes dists[i], t_starts[i], t_ends[i] and the extended-cigar of pair
 * i into cigar_buf + i * cigar_cap (NUL-terminated; dists[i] = -1 on
 * failure/overflow). Pairs run on `threads` worker threads (0 = one per
 * hardware core). */
void cf_align_path_batch(const int8_t* queries, const int32_t* qlens,
                         int32_t n, int64_t stride,
                         const int8_t* target, int32_t tlen,
                         int32_t mode, int32_t threads,
                         int32_t* dists, int32_t* t_starts,
                         int32_t* t_ends,
                         char* cigar_buf, int64_t cigar_cap);

/* Batch alignment-with-traceback over independent (query, target) PAIRS:
 * queries (n x qstride) and targets (n x tstride) padded row-major code
 * matrices with true lengths qlens/tlens. Output layout identical to
 * cf_align_path_batch. */
void cf_align_path_pairs(const int8_t* queries, const int32_t* qlens,
                         int64_t qstride,
                         const int8_t* targets, const int32_t* tlens,
                         int64_t tstride,
                         int32_t n, int32_t mode, int32_t threads,
                         int32_t* dists, int32_t* t_starts,
                         int32_t* t_ends,
                         char* cigar_buf, int64_t cigar_cap);

/* ---- streaming sequence reader ------------------------------------ */

typedef struct cf_reader cf_reader;

/* Open FASTA/FASTQ, plain or gzip (by magic bytes). NULL on failure. */
cf_reader* cf_reader_open(const char* path);
void cf_reader_close(cf_reader* r);

/* Read the next record. Writes the base codes (0..4) into codes_buf
 * (cap bytes) and the record id into id_buf (id_cap incl. NUL).
 * Returns sequence length (>= 0), -1 on EOF, -2 on buffer overflow
 * (call again with bigger buffers; the record is NOT consumed), -3 parse
 * error. */
int64_t cf_reader_next(cf_reader* r, int8_t* codes_buf, int64_t cap,
                       char* id_buf, int32_t id_cap);

/* ---- batch packing ------------------------------------------------- */

/* 2-bit pack a padded row-major (rows x len) code matrix (len % 8 == 0):
 * writes packed (rows x len/4, 4 codes/byte little-endian) and n_mask
 * (rows x len/8, bit b = code >= 4 at col 8q+b). Codes >= 4 pack as 0.
 * Positions at or beyond lens[r] (lens nullable = all full) never set
 * mask bits — they are don't-care for the device kernels. Returns 1 if
 * any in-range code >= 4 was seen, else 0 (n_mask then all zero). */
int32_t cf_pack2bit(const int8_t* codes, int64_t rows, int64_t len,
                    const int32_t* lens, uint8_t* packed, uint8_t* n_mask);

/* Encode + 2-bit pack ASCII bases seq[start : start+len] into one packed
 * row of out_bytes (zero-filled past len). Non-ACGT characters pack as 0;
 * returns 1 if any were seen, 0 otherwise, -1 if out_bytes is too small. */
int32_t cf_encode_pack_row(const char* seq, int64_t start, int64_t len,
                           uint8_t* out, int64_t out_bytes);

#ifdef __cplusplus
}
#endif

#endif /* CFNATIVE_H_ */
