"""Alt-call StringDecomposer report parsing (the 7-column variant).

Reference behavior (sd_parser_new.py:15-121, the newer string-based
parser): the TSV carries two extra columns (alt_call, alt_score); a
monomer position whose alternative call is NOT 'None' is considered
ambiguous and becomes a gap symbol, inter-monomer gaps longer than
max_gap insert round(gap/mean_len) gap symbols, reads with a lowercase
(reverse-monomer) majority are reversed + case-swapped, and the final
string is stripped of boundary gaps and split on gap runs into
`split_strings`. The reference file is dead code (imported by no
pipeline) but completes the component inventory; this version drops the
pandas dependency and reuses the letter mapping convention (A..Z upper =
forward monomer, lower = reverse).

The port's copy of the JAX package's `mono/sd_parser_alt.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

import csv
import dataclasses
from collections import Counter
from string import ascii_lowercase, ascii_uppercase
from typing import Dict, List, Tuple

import numpy as np

GAP_SYMB = "?"


@dataclasses.dataclass
class AltSDRecord:
    r_id: str
    string: str                      # letters over the monomer alphabet
    strand: str                      # '+' / '-' after majority flip
    gaps: List[Tuple[int, int]]      # nucleotide gap intervals
    split_strings: List[str]         # gap-free segments


@dataclasses.dataclass
class AltSDReport:
    records: Dict[str, AltSDRecord]
    monomer_names_map: Dict[str, str]

    def get_monomer_strings(self) -> Dict[str, str]:
        return {r_id: rec.string for r_id, rec in self.records.items()
                if len(rec.string)}


def _build_record(r_id: str, rows, max_gap: int,
                  mean_len: float) -> AltSDRecord:
    monomers = [r[0] for r in rows]
    r_st = [int(r[1]) for r in rows]
    r_en = [int(r[2]) for r in rows]
    alt_call = [r[4] for r in rows]

    string = [monomers[0] if alt_call[0] == "None" else GAP_SYMB]
    gaps: List[Tuple[int, int]] = []
    for i in range(1, len(rows)):
        gap_len = r_st[i] - r_en[i - 1]
        if gap_len > max_gap:
            gaps.append((r_en[i - 1], r_st[i]))
            string.append(GAP_SYMB * int(round(gap_len / mean_len)))
        string.append(monomers[i] if alt_call[i] == "None" else GAP_SYMB)
    s = "".join(string)

    cased = [c for c in s if c.lower() != c.upper()]
    frac_lower = (np.mean([c.islower() for c in cased]) if cased else 0.0)
    if frac_lower > 0.5:
        s = s[::-1].swapcase()
        strand = "-"
    else:
        strand = "+"
    s = s.strip(GAP_SYMB)
    split = [part for part in s.split(GAP_SYMB) if part]
    return AltSDRecord(r_id=r_id, string=s, strand=strand, gaps=gaps,
                       split_strings=split)


def parse_alt_sd_report(sd_report_fn: str, monomers_fn: str,
                        max_gap: int = 100) -> AltSDReport:
    """Parse the 7-column SD TSV (r_id, monomer, r_st, r_en, score,
    alt_call, alt_score)."""
    from centroflye_tpu_torch.io.fasta import read_seqs

    monomers = read_seqs(monomers_fn)
    mean_len = float(np.mean([len(m) for m in monomers.values()]))
    names_map: Dict[str, str] = {}
    for name, u, l in zip(monomers.keys(), ascii_uppercase,
                          ascii_lowercase):
        names_map[name] = u
        names_map[name + "'"] = l

    per_read: Dict[str, List] = {}
    order: List[str] = []
    with open(sd_report_fn) as f:
        for row in csv.reader(f, delimiter="\t"):
            if not row:
                continue
            r_id, monomer, st, en, score = row[:5]
            alt_call = row[5] if len(row) > 5 else "None"
            alt_score = row[6] if len(row) > 6 else "None"
            if r_id not in per_read:
                per_read[r_id] = []
                order.append(r_id)
            per_read[r_id].append(
                (names_map[monomer], st, en, score, alt_call, alt_score))

    records = {
        r_id: _build_record(r_id, per_read[r_id], max_gap, mean_len)
        for r_id in order
    }
    return AltSDReport(records=records, monomer_names_map=names_map)


def get_ngap_symbols(monostrings: Dict[str, str],
                     compr_hmp: bool = False) -> int:
    """Gap-symbol count; with compr_hmp, homopolymer-compressed first
    (counts gap RUNS — reference sd_parser_new.py:94-101)."""
    from centroflye_tpu_torch.io.encoding import compress_homopolymer

    cnt = 0
    for s in monostrings.values():
        if compr_hmp:
            s = compress_homopolymer(s)
        cnt += Counter(s)[GAP_SYMB]
    return cnt


def get_stats(monostrings: Dict[str, str], verbose: bool = False) -> Dict:
    """Length / gap statistics (reference sd_parser_new.py:104-126)."""
    lens = [len(s) for s in monostrings.values()]
    stats = {
        "ntranslations": len(lens),
        "min_len": int(np.min(lens)) if lens else 0,
        "max_len": int(np.max(lens)) if lens else 0,
        "mean_len": float(np.mean(lens)) if lens else 0.0,
        "tot_len": int(np.sum(lens)) if lens else 0,
    }
    stats["ngaps"] = get_ngap_symbols(monostrings)
    stats["pgaps"] = (stats["ngaps"] / stats["tot_len"]
                      if stats["tot_len"] else 0.0)
    stats["ngap_runs"] = get_ngap_symbols(monostrings, compr_hmp=True)
    if verbose:
        for k, v in stats.items():
            print(f"{k} = {v}")
    return stats


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Parse an alt-call (7-column) StringDecomposer report")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-m", "--monomers", required=True)
    args = parser.parse_args(argv)
    report = parse_alt_sd_report(args.input, args.monomers)
    get_stats(report.get_monomer_strings(), verbose=True)


if __name__ == "__main__":
    main()
