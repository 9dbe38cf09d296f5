"""Array-native monomer strings (reads over the monomer alphabet).

The reference's MonoString (reference sd_parser.py:15-155) is a Python list
of letters: uppercase A..R = forward monomer, lowercase = reverse-strand
monomer, '?' = gap, with a dict mapping monomer position -> nucleotide
coordinates. Here a monoread is an int16 numpy array:

    sym in [0, n)        forward monomer `sym`
    sym in [n, 2n)       reverse-strand monomer `sym - n`
    GAP (-1)             gap symbol

plus an (L, 2) int32 array of nucleotide (start, end) per position (-1 for
gaps) — vectorized trims/splits/Hamming scans instead of per-char loops, and
directly embeddable into device tensors. Letter round-tripping is kept for
artifact parity with the reference's string form.

The port's copy of the JAX package's `mono/monostring.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

import dataclasses
from string import ascii_lowercase, ascii_uppercase
from typing import Dict, List, Optional, Tuple

import numpy as np

GAP = np.int16(-1)


@dataclasses.dataclass
class MonoString:
    name: str
    syms: np.ndarray              # (L,) int16
    nucl: np.ndarray              # (L, 2) int32 nucleotide [start, end); -1
    n_monomers: int
    strand: str = "+"

    # -- construction -----------------------------------------------------

    @classmethod
    def from_sd_records(cls, name: str, monomers: np.ndarray,
                        starts: np.ndarray, ends: np.ndarray,
                        reliability: List[str], max_gap: int,
                        mean_monomer_len: float, n_monomers: int
                        ) -> "MonoString":
        """Build from StringDecomposer rows (reference sd_parser.py:25-54):
        unreliable calls become gaps; inter-monomer nucleotide gaps larger
        than max_gap insert round(gap/mean_len) gap symbols."""
        syms: List[int] = []
        nucl: List[Tuple[int, int]] = []

        def add_mono(m, s, e):
            syms.append(int(m))
            nucl.append((int(s), int(e)))

        def add_gap(k):
            for _ in range(k):
                syms.append(int(GAP))
                nucl.append((-1, -1))

        if reliability[0] == "+":
            add_mono(monomers[0], starts[0], ends[0])
        else:
            add_gap(1)
        for i in range(1, len(monomers)):
            gap_len = int(starts[i]) - int(ends[i - 1])
            if gap_len > max_gap:
                add_gap(int(round(gap_len / mean_monomer_len)))
            if reliability[i] == "+":
                add_mono(monomers[i], starts[i], ends[i])
            else:
                add_gap(1)
        ms = cls(name=name, syms=np.array(syms, dtype=np.int16),
                 nucl=np.array(nucl, dtype=np.int32).reshape(-1, 2),
                 n_monomers=n_monomers)
        ms = ms.strip()
        ms = ms.check_reverse()
        return ms

    # -- basics -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.syms)

    def is_gap(self) -> np.ndarray:
        return self.syms == GAP

    def is_reverse(self) -> np.ndarray:
        return self.syms >= self.n_monomers

    def swapcase(self) -> np.ndarray:
        """Strand-flip of symbols (fwd <-> rev); gaps unchanged."""
        s = self.syms
        n = self.n_monomers
        out = np.where(s == GAP, s,
                       np.where(s >= n, s - n, s + n)).astype(np.int16)
        return out

    def to_letters(self) -> str:
        """Reference-parity letter string (A.. = fwd, a.. = rev, ? = gap)."""
        out = []
        n = self.n_monomers
        for s in self.syms.tolist():
            if s == GAP:
                out.append("?")
            elif s >= n:
                out.append(ascii_lowercase[s - n])
            else:
                out.append(ascii_uppercase[s])
        return "".join(out)

    @classmethod
    def from_letters(cls, name: str, letters: str, n_monomers: int
                     ) -> "MonoString":
        syms = np.empty(len(letters), np.int16)
        for i, ch in enumerate(letters):
            if ch == "?":
                syms[i] = GAP
            elif ch.islower():
                syms[i] = ascii_lowercase.index(ch) + n_monomers
            else:
                syms[i] = ascii_uppercase.index(ch)
        nucl = np.full((len(letters), 2), -1, np.int32)
        return cls(name=name, syms=syms, nucl=nucl, n_monomers=n_monomers)

    # -- reference ops ----------------------------------------------------

    def check_reverse(self) -> "MonoString":
        """If more than half of the monomer calls are reverse-strand, flip
        the whole read (reference sd_parser.py:94-106): reverse order, swap
        strand of every symbol, swap nucleotide start/end."""
        nongap = self.syms != GAP
        if not nongap.any():
            return self
        frac_rev = float(self.is_reverse()[nongap].mean())
        if frac_rev <= 0.5:
            return self
        syms = self.swapcase()[::-1].copy()
        nucl = self.nucl[::-1, ::-1].copy()
        return MonoString(name=self.name, syms=syms, nucl=nucl,
                          n_monomers=self.n_monomers, strand="-")

    def trim(self, left: int, right: int) -> "MonoString":
        """Keep positions [left, right) (reference trim_read,
        sd_parser.py:108-113)."""
        return MonoString(name=self.name, syms=self.syms[left:right].copy(),
                          nucl=self.nucl[left:right].copy(),
                          n_monomers=self.n_monomers, strand=self.strand)

    def strip(self) -> "MonoString":
        """Remove leading/trailing gaps (reference sd_parser.py:115-121)."""
        nongap = np.nonzero(self.syms != GAP)[0]
        if len(nongap) == 0:
            return self.trim(0, 0)
        return self.trim(int(nongap[0]), int(nongap[-1]) + 1)

    def split_on_gaps(self, min_length: int
                      ) -> Dict[Tuple[str, int], "MonoString"]:
        """Split at gap symbols, keeping parts >= min_length (reference
        sd_parser.py:123-155 split semantics: parts indexed by their
        position among ALL gap-separated fragments)."""
        out: Dict[Tuple[str, int], MonoString] = {}
        gaps = np.nonzero(self.syms == GAP)[0]
        bounds = np.concatenate([[-1], gaps, [len(self.syms)]])
        for i in range(len(bounds) - 1):
            st, en = int(bounds[i]) + 1, int(bounds[i + 1])
            if en - st < min_length:
                continue
            part = MonoString(
                name=self.name, syms=self.syms[st:en].copy(),
                nucl=self.nucl[st:en].copy(),
                n_monomers=self.n_monomers, strand=self.strand)
            out[(self.name, i)] = part
        return out
