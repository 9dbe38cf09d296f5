/* centroflye_tpu_torch native runtime — C API.
 *
 * The 64-bit-word Myers bit-parallel edit-distance engine with optional
 * traceback (the edlib role of the reference's C/C++ inventory), built
 * from myers.cpp beside this header. The alignment half of the JAX
 * package's native/cfnative.h, copied; its reader and 2-bit packer
 * (seqio.cpp, which links zlib) are not part of this library.
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

#ifdef __cplusplus
}
#endif

#endif /* CFNATIVE_H_ */
