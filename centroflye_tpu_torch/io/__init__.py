from centroflye_tpu_torch.io.encoding import (  # noqa: F401
    ALPHABET,
    PAD,
    decode,
    encode,
    encode_batch,
    revcomp,
    revcomp_str,
    compress_homopolymer,
    min_cyclic_shift,
    kmer_codes,
    kmer_strings,
)
from centroflye_tpu_torch.io.fasta import (  # noqa: F401
    atomic_write,
    read_seq,
    read_seqs,
    write_seqs,
    iter_seqs,
)
