"""FASTA/FASTQ IO with transparent gzip (pure Python), identical to the
Python path of the JAX package's `io/fasta.py`."""

from __future__ import annotations

import contextlib
import glob
import gzip
import io
import os
from typing import Dict, Iterator, Tuple


@contextlib.contextmanager
def atomic_write(filename: str, mode: str = "w", **kwargs):
    """Crash-safe artifact writer: stream into `<name>.<pid>.tmp` in the
    destination directory and `os.replace` it into place only on clean
    exit (unlink on exception), so a stage killed mid-write leaves no
    file at the artifact path for a resumed run to trust."""
    path = os.path.abspath(filename)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # a SIGKILLed writer cannot clean its own tmp: sweep predecessors'
    # litter for this artifact (one live writer per artifact path)
    for stale in glob.glob(glob.escape(path) + ".*.tmp"):
        with contextlib.suppress(OSError):
            os.unlink(stale)
    tmp = f"{path}.{os.getpid()}.tmp"
    f = open(tmp, mode, **kwargs)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _open_text(filename: str):
    if filename.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(filename, "rb"), encoding="ascii")
    return open(filename, "r", encoding="ascii")


def _format_of(filename: str) -> str:
    base = filename[:-3] if filename.endswith(".gz") else filename
    ext = os.path.splitext(base)[1].lower()
    if ext in (".fq", ".fastq"):
        return "fastq"
    if ext in (".fa", ".fna", ".fasta"):
        return "fasta"
    return "auto"


def iter_seqs(filename: str) -> Iterator[Tuple[str, str]]:
    """Yield (seq_id, sequence) records, streaming. seq_id is the header token
    up to the first whitespace (BioPython's record.id)."""
    form = _format_of(filename)
    with _open_text(filename) as f:
        first_line = f.readline()
        if not first_line:
            return
        if form == "auto":
            form = "fastq" if first_line.startswith("@") else "fasta"
        if form == "fastq":
            line = first_line
            while line:
                header = line.strip()
                seq = f.readline().strip()
                f.readline()   # '+' separator
                f.readline()   # qualities
                if header:
                    yield header[1:].split()[0], seq
                line = f.readline()
        else:
            name = None
            parts = []
            line = first_line
            while line:
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(parts)
                    name = line.strip()[1:].split()[0]
                    parts = []
                else:
                    parts.append(line.strip())
                line = f.readline()
            if name is not None:
                yield name, "".join(parts)


def read_seq(filename: str) -> str:
    """First record's sequence."""
    for _, seq in iter_seqs(filename):
        return seq
    raise ValueError(f"no sequences in {filename}")


def write_seqs(filename: str, seqs: Dict[str, str]) -> None:
    """Write FASTA, one line per sequence. Atomic: see atomic_write."""
    with atomic_write(filename, encoding="ascii") as f:
        for seq_id, seq in seqs.items():
            f.write(f">{seq_id}\n{seq}\n")
