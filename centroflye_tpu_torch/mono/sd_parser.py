"""StringDecomposer report parsing -> monoreads.

Reference behavior (sd_parser.py:158-192): read the SD TSV (columns r_id,
monomer, r_st, r_en, score, reliability), map monomer names to letters
(name' = reverse strand), group rows by read, and build a MonoString per
read. Here grouping/parsing is plain csv + numpy (no pandas dependency) and
monomer identities are integer symbols (mono/monostring.py).

The port's copy of the JAX package's `mono/sd_parser.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

import csv
import dataclasses
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from centroflye_tpu_torch.mono.monostring import MonoString, GAP


@dataclasses.dataclass
class SDReport:
    monostrings: Dict[str, MonoString]
    monomer_names: List[str]          # index -> name (forward)
    n_monomers: int

    @classmethod
    def from_file(cls, sd_report_fn: str, monomers_fn: str,
                  max_gap: int = 100) -> "SDReport":
        from centroflye_tpu_torch.io.fasta import read_seqs

        monomers = read_seqs(monomers_fn)
        names = list(monomers.keys())
        mean_len = float(np.mean([len(s) for s in monomers.values()]))
        name2sym = {}
        for i, name in enumerate(names):
            name2sym[name] = i
            name2sym[name + "'"] = i + len(names)

        rows_by_read: Dict[str, List] = {}
        order: List[str] = []
        with open(sd_report_fn) as f:
            reader = csv.reader(f, delimiter="\t")
            for row in reader:
                if not row:
                    continue
                r_id, mono, r_st, r_en, score, rel = row[:6]
                if r_id not in rows_by_read:
                    rows_by_read[r_id] = []
                    order.append(r_id)
                rows_by_read[r_id].append(
                    (name2sym[mono], int(r_st), int(r_en), rel))
        monostrings = {}
        for r_id in order:
            rows = rows_by_read[r_id]
            monostrings[r_id] = MonoString.from_sd_records(
                name=r_id,
                monomers=np.array([r[0] for r in rows]),
                starts=np.array([r[1] for r in rows]),
                ends=np.array([r[2] for r in rows]),
                reliability=[r[3] for r in rows],
                max_gap=max_gap,
                mean_monomer_len=mean_len,
                n_monomers=len(names))
        return cls(monostrings=monostrings, monomer_names=names,
                   n_monomers=len(names))

    @classmethod
    def from_decomposition(cls, records, monomer_names: List[str],
                           max_gap: int = 100,
                           mean_monomer_len: float = 171.0) -> "SDReport":
        """Build directly from the in-repo monomer decomposer output
        (mono/string_decomposer.py) without the TSV round-trip."""
        monostrings = {}
        n = len(monomer_names)
        for r_id, rows in records.items():
            if not rows:
                continue
            monostrings[r_id] = MonoString.from_sd_records(
                name=r_id,
                monomers=np.array([r[0] for r in rows]),
                starts=np.array([r[1] for r in rows]),
                ends=np.array([r[2] for r in rows]),
                reliability=[r[3] for r in rows],
                max_gap=max_gap,
                mean_monomer_len=mean_monomer_len,
                n_monomers=n)
        return cls(monostrings=monostrings, monomer_names=monomer_names,
                   n_monomers=n)


def get_stats(monostrings: Dict[str, MonoString], verbose: bool = False):
    """Monoread statistics (reference sd_parser.py:204-226)."""
    lens = np.array([len(m) for m in monostrings.values()])
    total = int(lens.sum()) if len(lens) else 0
    ngaps = sum(int((m.syms == GAP).sum()) for m in monostrings.values())
    ngap_runs = 0
    for m in monostrings.values():
        g = (m.syms == GAP).astype(np.int8)
        if len(g):
            ngap_runs += int(g[0]) + int((np.diff(g) == 1).sum())
    stats = {
        "ntranslations": len(lens),
        "min_len": int(lens.min()) if len(lens) else 0,
        "max_len": int(lens.max()) if len(lens) else 0,
        "mean_len": float(lens.mean()) if len(lens) else 0.0,
        "tot_len": total,
        "ngaps": ngaps,
        "pgaps": ngaps / total if total else 0.0,
        "ngap_runs": ngap_runs,
    }
    if verbose:
        for key, val in stats.items():
            print(f"{key} = {val}")
    return stats
