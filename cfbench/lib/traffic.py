"""The one traffic generator: read streams made in bulk numpy from a seed.

A traffic mix is a JSON file of parameters (`cfbench/traffic/<mix>.json`)
that `generate` reads. It may hold three parts; each is optional:

- `stream`: `reads` reads with lengths from `lengths`; a `tandem.share`
  of them (rounded to the nearest read) are noisy tandem copies of a
  unit, the rest random sequence (the shape of `chip_smoke.make_reads`,
  chip_smoke.py:361-378, written in bulk);
- `array`: the reads of a simulated monomer array (`chip_smoke.cen6_world`,
  chip_smoke.py:2304-2336): `hors` copies of the monomers' higher-order
  repeat with a variant monomer at one in `variant_every`, reads of
  `lengths` (in monomers) at `coverage`, `noise`, strands half and half;
- `order`: "shuffle" puts the array's reads among the stream's in an
  order drawn from the seed; "stream" keeps the stream, then the array.

The read lengths, and which of them are tandem copies, come from the
mix's own `sizes_seed`, and the run's seed only orders them: every seed
gives the same set of sizes (and so the same amount of work), with other
sequences, noise, strands and order. The same seed gives the same
reads, byte for byte.

Frozen copies, with the line each came from: `rel2_lengths` and
`cen6_length_mix` as `lognormal_mix` (chip_smoke.py:351-358, 2282-2289),
`add_noise` (chip_smoke.py:1136-1155; the same noise model, with the
erring bases drawn as geometric gaps), `build_symbol_genome`
(chip_smoke.py:2267-2279). No file of the program is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cfbench.lib import spec

PAD = 4
ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
ENC = np.full(256, PAD, np.int8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
    ENC[_c + 32] = _i
COMP = np.array([3, 2, 1, 0, 4], np.int8)
LABELS = {"background": 0, "tandem": 1, "array": 2}


def encode(seq: str) -> np.ndarray:
    return ENC[np.frombuffer(seq.encode("ascii"), np.uint8)]


def decode(codes: np.ndarray) -> str:
    return ASCII[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][::-1]


def read_fasta(fn: str) -> dict:
    """{id: sequence} of a small FASTA file (ids to the first space)."""
    out, name, parts = {}, None, []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            elif line:
                parts.append(line)
    if name is not None:
        out[name] = "".join(parts)
    return out


def data_fasta(name: str) -> dict:
    return read_fasta(spec.path("data", name))


@dataclasses.dataclass
class Reads:
    """A read set in one code plane: read i is codes[offs[i]:offs[i+1]]."""

    ids: list
    codes: np.ndarray         # int8, every read concatenated
    offs: np.ndarray          # int64 (n + 1,)
    labels: np.ndarray        # int8 (n,): LABELS
    strands: np.ndarray       # int8 (n,): 1 where the read is a reverse copy

    def __len__(self):
        return len(self.ids)

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    def seq(self, i: int) -> np.ndarray:
        return self.codes[self.offs[i]:self.offs[i + 1]]

    def text(self, i: int) -> str:
        return decode(self.seq(i))

    def fasta_bytes(self, idx=None) -> bytes:
        """The reads (all, or `idx` in that order) as FASTA, one line a
        sequence."""
        idx = range(len(self)) if idx is None else idx
        asc = ASCII[self.codes]
        parts = []
        for i in idx:
            parts.append(b">" + self.ids[i].encode() + b"\n")
            parts.append(asc[self.offs[i]:self.offs[i + 1]].tobytes())
            parts.append(b"\n")
        return b"".join(parts)

    def write_fasta(self, fn: str, idx=None) -> int:
        data = self.fasta_bytes(idx)
        with open(fn, "wb") as f:
            f.write(data)
        return len(data)


def lognormal_mix(rng, n: int, spec_: dict) -> np.ndarray:
    """n lengths from a mixture of lognormals: `mix` lists [weight,
    median, sigma] components, `clip` [lo, hi] bounds them."""
    mix = np.asarray(spec_["mix"], np.float64)
    cum = np.cumsum(mix[:, 0] / mix[:, 0].sum())
    comp = np.searchsorted(cum, rng.random(n), side="right")
    comp = np.minimum(comp, len(mix) - 1)
    draws = np.stack([rng.lognormal(np.log(med), sig, n)
                      for _, med, sig in mix])
    lens = draws[comp, np.arange(n)]
    lo, hi = spec_["clip"]
    return np.clip(lens, lo, hi).astype(np.int64)


def add_noise(rng, src: np.ndarray, rate: float, at=None):
    """Uniform noise at `rate` on a code array, in bulk: each base in turn
    is, with a third of `rate` each, deleted, given a random base before
    it, or substituted. The erring bases are drawn as geometric gaps.
    Returns the noisy codes and where each source position of `at`
    (sorted, the source's length allowed) lands in them."""
    n = src.size
    pos = np.zeros(0, np.int64)
    while n and (pos.size == 0 or pos[-1] < n - 1):
        k = int(n * rate + 6 * np.sqrt(n * rate) + 16)
        more = np.cumsum(rng.geometric(rate, k)) + (pos[-1] if pos.size
                                                     else -1)
        pos = np.concatenate([pos, more])
    pos = pos[pos < n]
    kind = rng.integers(0, 3, pos.size)
    dele, ins, sub = pos[kind == 0], pos[kind == 1], pos[kind == 2]
    src = src.copy()
    src[sub] = (src[sub] + rng.integers(1, 4, sub.size)) % 4
    out = np.insert(np.delete(src, dele), ins - np.searchsorted(dele, ins),
                    rng.integers(0, 4, ins.size).astype(np.int8))
    if at is None:
        return out, None
    at = np.asarray(at, np.int64)
    return out, at + np.searchsorted(ins, at) - np.searchsorted(dele, at)


def noisy_pieces(rng, sources: list, rate: float, chunk_bp: int = 1 << 26):
    """`add_noise` over many source pieces, in chunks of about chunk_bp
    bases: -> the noisy pieces, in order."""
    out, i = [], 0
    while i < len(sources):
        j, bp = i, 0
        while j < len(sources) and (bp == 0 or bp + sources[j].size
                                     <= chunk_bp):
            bp += sources[j].size
            j += 1
        at = np.concatenate([[0], np.cumsum([s.size for s in sources[i:j]])])
        noisy, cut = add_noise(rng, np.concatenate(sources[i:j]), rate, at)
        out += [noisy[cut[k]:cut[k + 1]] for k in range(j - i)]
        i = j
    return out


def build_symbol_genome(rng, n_hor: int, n_mono: int, variant_every: int):
    """n_hor copies of the n_mono-monomer HOR with a monomer substituted
    at one in `variant_every` positions."""
    syms = np.tile(np.arange(n_mono, dtype=np.int16), n_hor)
    n_var = len(syms) // variant_every
    marks = rng.choice(len(syms), size=n_var, replace=False)
    shift = rng.integers(1, n_mono, n_var).astype(np.int16)
    syms[marks] = (syms[marks] + shift) % n_mono    # any other monomer
    return syms


def _stream(rng, sizes, p: dict):
    """The stream's pieces: (codes, label, strand) a read."""
    n = int(p["reads"])
    lens = lognormal_mix(sizes, n, p["lengths"])
    tandem = p.get("tandem")
    # which lengths are tandem copies comes from the sizes too, so every
    # seed has the same tandem bases; the seed only orders the reads
    n_t = round(n * tandem["share"]) if tandem else 0
    is_t = np.zeros(n, bool)
    is_t[sizes.choice(n, n_t, replace=False)] = True
    order = rng.permutation(n)
    lens, is_t = lens[order], is_t[order]
    t_idx = np.nonzero(is_t)[0]
    bg = np.frombuffer(rng.bytes(int(lens[~is_t].sum())), np.uint8) & 3
    bg = bg.astype(np.int8)
    pieces, labels, strands = [None] * n, np.zeros(n, np.int8), \
        np.zeros(n, np.int8)
    at = 0
    for i in np.nonzero(~is_t)[0]:
        pieces[i] = bg[at:at + lens[i]]
        at += lens[i]
    if n_t:
        unit = encode(next(iter(data_fasta(tandem["unit"]).values())))
        m = unit.size
        rot = rng.integers(0, m, n_t)
        srcs = []
        for k, i in enumerate(t_idx):
            want = int(lens[i] * 1.2) + 64          # room for deletions
            reps = -(-(want + rot[k]) // m)
            srcs.append(np.tile(unit, reps)[rot[k]:rot[k] + want])
        noisy = noisy_pieces(rng, srcs, float(tandem["noise"]))
        rc = rng.permutation(n_t) < n_t // 2        # strands half and half
        for k, i in enumerate(t_idx):
            piece = noisy[k][:lens[i]]
            pieces[i] = revcomp(piece) if rc[k] else piece
            labels[i] = LABELS["tandem"]
            strands[i] = rc[k]
    return pieces, labels, strands


def _array(rng, sizes, p: dict):
    """The monomer array's reads: (codes, label, strand) a read."""
    monomers = [encode(s) for s in data_fasta(p["monomers"]).values()]
    syms = build_symbol_genome(rng, int(p["hors"]), len(monomers),
                               int(p["variant_every"]))
    mlen = np.array([c.size for c in monomers])[syms]
    bounds = np.concatenate([[0], np.cumsum(mlen)])
    arr = np.concatenate([monomers[s] for s in syms])
    L = len(syms)
    n = int(float(p["coverage"]) * L / float(p["mean_monomers"]))
    lens = rng.permutation(lognormal_mix(sizes, n, p["lengths"]))
    starts = rng.integers(-50, L - 20, size=n)
    s = np.maximum(0, starts)
    e = np.minimum(L, s + lens)
    keep = (e - s) >= 30
    s, e = s[keep], e[keep]
    a = bounds[s] + (rng.random(s.size) * mlen[s]).astype(np.int64)
    b = bounds[e - 1] + 1 + (rng.random(s.size) * mlen[e - 1]).astype(
        np.int64)
    noisy = noisy_pieces(rng, [arr[x:y] for x, y in zip(a, b)],
                         float(p["noise"]))
    rc = rng.random(s.size) < 0.5
    pieces = [revcomp(c) if r else c for c, r in zip(noisy, rc)]
    return (pieces, np.full(s.size, LABELS["array"], np.int8),
            rc.astype(np.int8))


def generate(mix: dict, seed: int) -> Reads:
    """The mix's reads for `seed` (any whole number >= 0)."""
    rng = np.random.default_rng([int(seed), 0x6366])
    parts = []
    for key, make in (("stream", _stream), ("array", _array)):
        if key in mix:
            sizes = np.random.default_rng([int(mix["sizes_seed"]),
                                           len(parts)])
            parts.append(make(rng, sizes, mix[key]))
    pieces = [p for part in parts for p in part[0]]
    labels = np.concatenate([part[1] for part in parts])
    strands = np.concatenate([part[2] for part in parts])
    order = np.arange(len(pieces))
    if mix.get("order", "stream") == "shuffle":
        order = rng.permutation(len(pieces))
    lens = np.array([pieces[i].size for i in order], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes = np.empty(int(offs[-1]), np.int8)
    for k, i in enumerate(order):
        codes[offs[k]:offs[k + 1]] = pieces[i]
    ids = [f"r{k:06d}" for k in range(len(order))]
    return Reads(ids, codes, offs, labels[order], strands[order])
