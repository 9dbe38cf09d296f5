"""De novo unit extraction + clustering (standalone exploratory tools).

Reference behavior:
- unit_extractor (scripts/unit_extractor.py): per read, find the tandem
  period without knowing the unit: histogram the position differences of
  repeated k=15-mers ("convolution", :33-40), locate the period peak with a
  sliding 2-bin window (get_period_info, :43-78), pick the "hook" k-mer with
  the max in-bin tandem index (:81-89), split the read at hook occurrences
  (:92-103) and polish the splits against the median-length split
  (run_on_read, :106-151 — Flye there, the in-repo consensus polisher here).
- unit_clusterer (scripts/unit_clusterer.py): cluster per-read polished
  units by length bin, pick the median one and polish the cluster consensus
  (:41-87).

Host code, a copy of the JAX package's `stages/unit_extraction.py` on the
port's `stages/consensus.polish_consensus` (native alignments) and
`stages/polisher.median_high`. Its CLI:

    python -m centroflye_tpu_torch.stages.unit_extraction \
        --reads reads.fasta --output units.fasta [--cluster]
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import encode, kmer_codes


def get_convolution(seq: str, k: int = 15, max_period: int = 10000
                    ) -> Counter:
    """Histogram of distances between consecutive occurrences of repeated
    k-mers (reference unit_extractor.py:33-40 semantics: per k-mer, all
    successive-occurrence differences)."""
    codes, valid = kmer_codes(encode(seq), k)
    positions: Dict[int, int] = {}
    conv: Counter = Counter()
    last_pos: Dict[int, int] = {}
    for i in np.nonzero(valid)[0].tolist():
        c = int(codes[i])
        if c in last_pos:
            d = i - last_pos[c]
            if 0 < d <= max_period:
                conv[d] += 1
        last_pos[c] = i
    return conv


def get_period_info(conv: Counter, bin_size: int = 50,
                    min_period: int = 50) -> Optional[Tuple[int, int]]:
    """(period_low, period_high) window containing the dominant period: the
    2-bin sliding window with maximal total convolution mass (reference
    get_period_info, unit_extractor.py:43-78 simplified to its fixpoint)."""
    if not conv:
        return None
    max_d = max(conv)
    if max_d < min_period:
        return None
    best_mass, best_lo = 0, None
    for lo in range(min_period, max_d + 1, bin_size):
        mass = sum(c for d, c in conv.items() if lo <= d < lo + 2 * bin_size)
        if mass > best_mass:
            best_mass, best_lo = mass, lo
    if best_lo is None:
        return None
    return best_lo, best_lo + 2 * bin_size


def find_hook(seq: str, period_range: Tuple[int, int], k: int = 15
              ) -> Optional[int]:
    """The k-mer code whose successive occurrences fall inside the period
    window most often (the "hook", reference unit_extractor.py:81-89)."""
    lo, hi = period_range
    codes, valid = kmer_codes(encode(seq), k)
    last_pos: Dict[int, int] = {}
    tandem_index: Counter = Counter()
    for i in np.nonzero(valid)[0].tolist():
        c = int(codes[i])
        if c in last_pos and lo <= i - last_pos[c] < hi:
            tandem_index[c] += 1
        last_pos[c] = i
    if not tandem_index:
        return None
    best = max(sorted(tandem_index), key=lambda c: tandem_index[c])
    return best


def split_at_hook(seq: str, hook: int, k: int = 15) -> List[str]:
    """Split the read at every occurrence of the hook k-mer (reference
    unit_extractor.py:92-103); first/last partial splits dropped."""
    codes, valid = kmer_codes(encode(seq), k)
    hits = [i for i in np.nonzero(valid)[0].tolist()
            if int(codes[i]) == hook]
    units = []
    for a, b in zip(hits[:-1], hits[1:]):
        units.append(seq[a:b])
    return units


@dataclasses.dataclass
class ExtractedUnits:
    period_range: Optional[Tuple[int, int]]
    hook: Optional[int]
    units: List[str]
    consensus: Optional[str]


def extract_units_from_read(seq: str, k: int = 15, bin_size: int = 50,
                            polish_iters: int = 2,
                            min_units: int = 3) -> ExtractedUnits:
    """Full per-read extraction: period -> hook -> splits -> consensus
    (reference run_on_read, unit_extractor.py:106-151, with the in-repo
    consensus polisher instead of Flye)."""
    from centroflye_tpu_torch.stages.consensus import polish_consensus
    from centroflye_tpu_torch.stages.polisher import median_high

    conv = get_convolution(seq, k=k)
    period = get_period_info(conv, bin_size=bin_size)
    if period is None:
        return ExtractedUnits(None, None, [], None)
    hook = find_hook(seq, period, k=k)
    if hook is None:
        return ExtractedUnits(period, None, [], None)
    units = split_at_hook(seq, hook, k=k)
    units = [u for u in units if period[0] <= len(u) < period[1]]
    if len(units) < min_units:
        return ExtractedUnits(period, hook, units, None)
    med = median_high([len(u) for u in units])
    template = next(u for u in sorted(units, key=len) if len(u) >= med) \
        if any(len(u) >= med for u in units) else units[0]
    polished = polish_consensus(template, units, n_iters=polish_iters)
    return ExtractedUnits(period, hook, units, polished[polish_iters])


def cluster_units(per_read_units: Dict[str, str], bin_size: int = 50,
                  polish_iters: int = 2,
                  min_cluster: int = 2) -> List[str]:
    """Cluster per-read consensus units by length bin and polish each
    cluster's consensus (reference unit_clusterer.py:41-87)."""
    from centroflye_tpu_torch.stages.consensus import polish_consensus
    from centroflye_tpu_torch.stages.polisher import median_high

    bins: Dict[int, List[str]] = defaultdict(list)
    for unit in per_read_units.values():
        bins[len(unit) // bin_size].append(unit)
    consensi = []
    for b in sorted(bins):
        members = bins[b]
        if len(members) < min_cluster:
            continue
        med = median_high([len(u) for u in members])
        template = next((u for u in sorted(members, key=len)
                         if len(u) == med), members[0])
        polished = polish_consensus(template, members,
                                    n_iters=polish_iters)
        consensi.append(polished[polish_iters])
    return consensi


def plot_period_histogram(conv: Counter, filename: str,
                          period: Optional[Tuple[int, int]] = None) -> bool:
    """Write the k-mer position-difference ("convolution") histogram as a
    PDF (the reference's per-read diagnostic plot,
    unit_extractor.py:148-151). Returns False when matplotlib is absent
    (headless installs) instead of failing the extraction."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(8, 4))
    if conv:
        xs = np.array(sorted(conv))
        ys = np.array([conv[x] for x in xs])
        ax.vlines(xs, 0, ys, linewidth=1)
    if period is not None:
        ax.axvspan(period[0], period[1], alpha=0.2,
                   label=f"period bin [{period[0]}, {period[1]})")
        ax.legend()
    ax.set_xlabel("k-mer position difference (bp)")
    ax.set_ylabel("count")
    ax.set_title("tandem period convolution")
    fig.tight_layout()
    fig.savefig(filename)
    plt.close(fig)
    return True


def main(argv=None):
    import argparse

    from centroflye_tpu_torch.io import iter_seqs, write_seqs

    parser = argparse.ArgumentParser(
        description="De novo tandem unit extraction from reads")
    parser.add_argument("--reads", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("-k", type=int, default=15)
    parser.add_argument("--bin-size", type=int, default=50)
    parser.add_argument("--cluster", action="store_true",
                        help="also cluster per-read units")
    parser.add_argument("--plot-dir", help="write per-read period "
                        "histogram PDFs here (reference "
                        "unit_extractor.py:148-151)")
    args = parser.parse_args(argv)

    if args.plot_dir:
        os.makedirs(args.plot_dir, exist_ok=True)
    per_read = {}
    for r_id, seq in iter_seqs(args.reads):
        res = extract_units_from_read(seq, k=args.k,
                                      bin_size=args.bin_size)
        if args.plot_dir:
            plot_period_histogram(
                get_convolution(seq, k=args.k),
                os.path.join(args.plot_dir, f"{r_id}_period.pdf"),
                period=res.period_range)
        if res.consensus:
            per_read[r_id] = res.consensus
    write_seqs(args.output, {f"{r}_unit": u for r, u in per_read.items()})
    if args.cluster and per_read:
        consensi = cluster_units(per_read, bin_size=args.bin_size)
        write_seqs(args.output + ".clusters.fasta",
                   {f"cluster_{i}": c for i, c in enumerate(consensi)})


if __name__ == "__main__":
    main()
