"""The port's rare-k-mer stage (`stages/rare_kmers.py`) against the JAX
package on the same numpy-seeded reads, exactly: the length-tiered
batches, the occurrence hash and mask, `read_kmer_table` with the
occurrence prefilter on and off at several batch sizes (so the merge
forest folds different tables), and `get_rare_kmers`. The read worlds are
those of `tests/test_kmer_recruitment.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.config import KmerRecruitmentConfig as JCfg
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import rare_kmers as jrare

from centroflye_tpu_torch.config import KmerRecruitmentConfig as TCfg
from centroflye_tpu_torch.ops.kmers import join_keys
from centroflye_tpu_torch.stages import rare_kmers as trare

K = 13


def _reads(seed, n=10):
    """Noisy copies of one base sequence, with in-read repeats, an empty
    read, a read shorter than k and an N run."""
    rng = np.random.default_rng(seed)
    base = gen_random_seq(rng, 400)
    seqs = []
    for i in range(n):
        if i % 3 == 0:
            seqs.append(base[:150] + base[:150])
        else:
            seqs.append(add_read_noise(rng, base, 0.05))
    seqs += ["", "ACGT", base[:60] + "NNNN" + base[60:200]]
    return seqs


def test_iter_batches_equal():
    seqs = _reads(0) + ["A" * 5000]
    n_batches = []
    for rows, pad, budget in ((3, 256, 1 << 24), (64, 256, 1 << 10),
                              (1, 16, 1 << 12)):
        got = list(trare._iter_batches(seqs, rows, pad, budget))
        want = list(jrare._iter_batches(seqs, rows, pad, budget))
        assert len(got) == len(want)
        n_batches.append(len(got))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert n_batches[0] == 1 and n_batches[2] > 2


def test_occurrence_pass_matches_jax():
    """The hashed count table after pass A, and pass B's mask, on the
    same batches (every table slot compared)."""
    seqs = _reads(1)
    jt = jnp.zeros(1 << jrare._HASH_BITS, jnp.int32)
    tt = torch.zeros(1 << trare._HASH_BITS, dtype=torch.int32)
    batches = list(jrare._iter_batches(seqs, 4, 256))
    for _, codes, lens in batches:
        jt = jrare._occ_accumulate(jt, codes, lens, k=K)
        trare._occ_accumulate(tt, torch.from_numpy(codes),
                              torch.from_numpy(lens), k=K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tt.sum()) > 0
    for _, codes, lens in batches:
        hi, lo, n = jrare._occ_mask(jt, codes, lens, jnp.int32(3), k=K)
        keys, tn = trare._occ_mask(tt, torch.from_numpy(codes),
                                   torch.from_numpy(lens), 3, k=K)
        want = join_keys(torch.from_numpy(np.asarray(hi).astype(np.int64)),
                         torch.from_numpy(np.asarray(lo).astype(np.int64)))
        assert torch.equal(keys, want) and int(tn) == int(n)


@pytest.mark.parametrize("min_occ", [0, 3])
@pytest.mark.parametrize("batch_rows", [1, 3, 64])
def test_read_kmer_table_matches_jax(min_occ, batch_rows):
    seqs = _reads(2)
    want = jrare.read_kmer_table(seqs, K, batch_rows=batch_rows,
                                 min_occurrences=min_occ)
    got = trare.read_kmer_table(seqs, K, batch_rows=batch_rows,
                                min_occurrences=min_occ, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert (got[2] > 0).any() and len(got[0]) > 100


def test_read_kmer_table_small_capacity_matches_jax():
    """A global capacity below the distinct count: every merge retries
    larger, as in the JAX package."""
    seqs = _reads(3)
    want = jrare.read_kmer_table(seqs, K, batch_rows=2, capacity=256)
    got = trare.read_kmer_table(seqs, K, batch_rows=2, capacity=256,
                                device="cpu")
    assert len(got[0]) > 256
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("coverage,max_nonuniq", [(8, 2), (4, 3)])
def test_get_rare_kmers_matches_jax(coverage, max_nonuniq):
    rng = np.random.default_rng(coverage)
    base = gen_random_seq(rng, 300)
    seqs = [add_read_noise(rng, base, 0.03) for _ in range(12)]
    seqs += [base[:100] * 3 for _ in range(4)]   # heavy in-read repeats
    kw = dict(k=K, max_nonuniq=max_nonuniq, bottom=0.9, top=3.0,
              kmer_survival_rate=0.5)
    want = jrare.get_rare_kmers(seqs, JCfg(**kw), coverage, batch_rows=4)
    got = trare.get_rare_kmers(seqs, TCfg(**kw), coverage, batch_rows=4,
                               device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint64 and len(got) > 0


def test_empty_input():
    for a, b in zip(trare.read_kmer_table([], K, device="cpu"),
                    jrare.read_kmer_table([], K)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rare stage's CUDA path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("min_occ", [0, 3])
def test_read_kmer_table_on_gpu_matches_cpu(cuda, min_occ):
    seqs = _reads(4)
    want = trare.read_kmer_table(seqs, K, batch_rows=3,
                                 min_occurrences=min_occ, device="cpu")
    got = trare.read_kmer_table(seqs, K, batch_rows=3,
                                min_occurrences=min_occ, device=cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
