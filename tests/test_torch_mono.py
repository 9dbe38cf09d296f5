"""The port's host copies of the cen6 monomer layer (`centroflye_tpu_torch/
mono/`: monostrings, the SD TSV, error correction, the monomer de Bruijn
graph, iterative assembly, scaffolding, pseudounits, the alt-call
parser) against the JAX package's, on the same numpy-seeded inputs:
every output equal, dict order included (it feeds every tie downstream),
and every written file byte for byte. Also pins the two reference faults
the port matches: `MonoConfig.auto_join` on by default, so an exact
repeat of >= 50 monomers joins two scaffolds, and `count_specific_kmers`
counting a duplicated query twice."""

import dataclasses
import os

import numpy as np
import pytest

from centroflye_tpu import config as jconfig
from centroflye_tpu.io import write_seqs
from centroflye_tpu.mono import debruijn as jdb
from centroflye_tpu.mono import error_correction as jec
from centroflye_tpu.mono import monostring as jms
from centroflye_tpu.mono import scaffolding as jsc
from centroflye_tpu.mono import sd_parser as jsd
from centroflye_tpu.mono import sd_parser_alt as jalt
from centroflye_tpu.pipeline.simulate import gen_random_seq

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch.mono import debruijn as tdb
from centroflye_tpu_torch.mono import error_correction as tec
from centroflye_tpu_torch.mono import monostring as tms
from centroflye_tpu_torch.mono import scaffolding as tsc
from centroflye_tpu_torch.mono import sd_parser as tsd
from centroflye_tpu_torch.mono import sd_parser_alt as talt

N_MONO = 6
SCAFFOLD_SEED = 1       # a world whose k = 20 graph gives three scaffolds


def norm(x):
    """A comparable form of an output: MonoStrings by their fields, arrays
    with their dtype, dicts as item lists in order."""
    if isinstance(x, (jms.MonoString, tms.MonoString)):
        return ("MonoString", x.name, x.syms.dtype.str, x.syms.tolist(),
                x.nucl.tolist(), x.n_monomers, x.strand)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return ("dict", [(norm(k), norm(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [norm(v) for v in x])
    if isinstance(x, set):
        return ("set", sorted(norm(v) for v in x))
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return x


def assert_same(j, t):
    assert norm(j) == norm(t)


def graph_state(db):
    return norm((db.k, db.node_ids,
                 {e: (x.u, x.v, x.syms, x.coverages, x.color)
                  for e, x in db.edges.items()},
                 dict(db.out_edges), dict(db.in_edges), db._next_edge))


def pair(name, syms, nucl=None, strand="+", n=N_MONO):
    """The same monostring in both packages."""
    syms = np.asarray(syms, np.int16)
    nucl = (np.full((len(syms), 2), -1, np.int32) if nucl is None
            else np.asarray(nucl, np.int32))
    return (jms.MonoString(name=name, syms=syms.copy(), nucl=nucl.copy(),
                           n_monomers=n, strand=strand),
            tms.MonoString(name=name, syms=syms.copy(), nucl=nucl.copy(),
                           n_monomers=n, strand=strand))


def symbol_world(seed, n_hor=40, n_reads=80, gap_rate=0.04, rev=0.1,
                 every=8):
    """A monomer-space array (HOR copies with a variant at one in `every`
    positions) and reads over it: gaps, a few reverse-strand calls and
    whole reverse reads, nucleotide spans of 170 a monomer. -> (array
    symbols, {r_id: (syms, nucl)})."""
    rng = np.random.default_rng(seed)
    syms = np.tile(np.arange(N_MONO, dtype=np.int16), n_hor)
    for pos in rng.choice(len(syms), len(syms) // every, replace=False):
        syms[pos] = (syms[pos] + rng.integers(1, N_MONO)) % N_MONO
    reads = {}
    for i in range(n_reads):
        n = int(rng.integers(15, 90))
        s = int(rng.integers(0, len(syms) - n))
        r = syms[s:s + n].copy()
        r[rng.random(n) < rev * 0.3] += N_MONO
        if rng.random() < rev:
            r = np.where(r >= N_MONO, r - N_MONO, r + N_MONO)[::-1]
        r = np.where(rng.random(n) < gap_rate, jms.GAP, r).astype(np.int16)
        nucl = np.stack([np.arange(n) * 170, np.arange(n) * 170 + 170], 1)
        nucl[r == jms.GAP] = -1
        reads[f"r{i:03d}"] = (r, nucl)
    return syms, reads


def both(reads, strand="+"):
    js, ts = {}, {}
    for r_id, (s, nucl) in reads.items():
        js[r_id], ts[r_id] = pair(r_id, s, nucl, strand)
    return js, ts


@pytest.fixture(scope="module")
def world():
    return symbol_world(5)


@pytest.mark.parametrize("letters", ["ABCab?F", "abcD", "??AB?CDE??",
                                     "?", "", "aaaa?bB"])
def test_monostring_ops(letters):
    j = jms.MonoString.from_letters("r", letters, N_MONO)
    t = tms.MonoString.from_letters("r", letters, N_MONO)
    assert_same(j, t)
    assert j.to_letters() == t.to_letters() == letters
    assert_same(j.swapcase(), t.swapcase())
    assert_same((j.is_gap(), j.is_reverse()), (t.is_gap(), t.is_reverse()))
    assert_same(j.check_reverse(), t.check_reverse())
    assert_same(j.strip(), t.strip())
    assert_same(j.trim(1, 3), t.trim(1, 3))
    for k in (1, 2, 3):
        assert_same(j.split_on_gaps(k), t.split_on_gaps(k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_sd_records(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    monomers = rng.integers(0, 2 * N_MONO, n)
    starts = np.cumsum(rng.integers(150, 600, n))
    ends = starts + rng.integers(120, 200, n)
    rel = ["+" if x else "-" for x in rng.random(n) < 0.8]
    args = dict(name="r", monomers=monomers, starts=starts, ends=ends,
                reliability=rel, max_gap=100, mean_monomer_len=170.0,
                n_monomers=N_MONO)
    assert_same(jms.MonoString.from_sd_records(**args),
                tms.MonoString.from_sd_records(**args))


def test_sd_report_tsv_and_stats(tmp_path):
    """tests/test_mono.py's SD TSV, and a larger one, through both
    parsers; from_decomposition on the same records; get_stats."""
    rng = np.random.default_rng(7)
    monomers_fn = str(tmp_path / "monomers.fasta")
    names = [f"m{i}" for i in range(N_MONO)]
    write_seqs(monomers_fn, {n: gen_random_seq(rng, 168 + i)
                             for i, n in enumerate(names)})
    rows = [("read1", "m0", 0, 170, 100.0, "+"),
            ("read1", "m1", 171, 341, 99.0, "+"),
            ("read1", "m2'", 342, 512, 98.0, "+"),
            ("read2", "m1'", 0, 170, 97.0, "+"),
            ("read2", "m0'", 171, 341, 96.0, "+")]
    records = {}
    for r in range(12):
        pos = 0
        for _ in range(int(rng.integers(1, 30))):
            sym = int(rng.integers(0, 2 * N_MONO))
            pos += int(rng.integers(0, 400))
            rel = "+" if rng.random() < 0.85 else "-"
            rows.append((f"x{r}", names[sym % N_MONO]
                         + ("'" if sym >= N_MONO else ""), pos, pos + 170,
                         50.0, rel))
            records.setdefault(f"x{r}", []).append((sym, pos, pos + 170,
                                                    rel))
            pos += 170
    tsv = str(tmp_path / "sd.tsv")
    with open(tsv, "w") as f:
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n\n")
    j = jsd.SDReport.from_file(tsv, monomers_fn)
    t = tsd.SDReport.from_file(tsv, monomers_fn)
    assert_same((j.monostrings, j.monomer_names, j.n_monomers),
                (t.monostrings, t.monomer_names, t.n_monomers))
    assert t.monostrings["read1"].to_letters() == "ABc"
    assert jsd.get_stats(j.monostrings) == tsd.get_stats(t.monostrings)
    records["empty"] = []
    j = jsd.SDReport.from_decomposition(records, names, 100, 169.5)
    t = tsd.SDReport.from_decomposition(records, names, 100, 169.5)
    assert_same((j.monostrings, j.monomer_names, j.n_monomers),
                (t.monostrings, t.monomer_names, t.n_monomers))
    assert jsd.get_stats({}) == tsd.get_stats({})


@pytest.mark.parametrize("window", [5, 30])
def test_error_correction_passes(world, window):
    _, reads = world
    js, ts = both(reads)
    assert_same(jec.moving_average(np.arange(40) % 3, window),
                tec.moving_average(np.arange(40) % 3, window))
    jf = jec.filter_lowercaserich_reads(js, 0.1)
    tf = tec.filter_lowercaserich_reads(ts, 0.1)
    assert_same(jf, tf)
    jt, tt = (jec.trim_reads(jf, 0.2, window),
              tec.trim_reads(tf, 0.2, window))
    assert_same(jt, tt)
    assert_same(jec.cut_gaprich_reads(jt, 0.05, 10),
                tec.cut_gaprich_reads(tt, 0.05, 10))
    for min_mult in (5, 50, 10 ** 6):
        assert_same(jec.infer_hors(jt, 3, min_mult),
                    tec.infer_hors(tt, 3, min_mult))
    assert_same(jec.correct_gaps(dict(jt), k=3, min_mult=20),
                tec.correct_gaps(dict(tt), k=3, min_mult=20))
    n = min(len(js["r000"]), len(js["r001"]))
    a, b = js["r000"].syms[:n], js["r001"].syms[:n]
    assert jec.hamming_with_wildcard(a, b) == tec.hamming_with_wildcard(a, b)
    for x in ([2, 0, 1], [1, 1, 0, 1], [], [3, 3, 3]):
        x = np.array(x, np.int16)
        assert_same(jec.min_cyclic_shift_arr(x), tec.min_cyclic_shift_arr(x))


@pytest.mark.parametrize("hor_correction", [True, False])
def test_error_correction_chain(world, hor_correction, capsys):
    _, reads = world
    js, ts = both(reads)
    kw = dict(verbose=True, hor_correction=hor_correction, cut_min_length=10,
              hor_min_mult=30, trim_ma_window=10)
    assert_same(jec.error_correction(js, **kw), tec.error_correction(ts, **kw))
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]


@pytest.mark.parametrize("k", [1, 3, 7, 40])
def test_rolling_hashes(world, k):
    _, reads = world
    for s, _ in list(reads.values())[:10]:
        assert_same(jdb.rolling_kmer_hashes(s, k),
                    tdb.rolling_kmer_hashes(s, k))


@pytest.mark.parametrize("k,min_mult", [(3, 5), (12, 3), (30, 2)])
def test_frequent_and_all_kmers(world, k, min_mult):
    _, reads = world
    js, ts = both(reads)
    for with_locations in (True, False):
        assert_same(jdb.get_frequent_kmers(js, k, min_mult, with_locations),
                    tdb.get_frequent_kmers(ts, k, min_mult, with_locations))
    strings = {r: s for r, (s, _) in reads.items()}
    assert_same(jdb.get_frequent_kmers(strings, k, min_mult),
                tdb.get_frequent_kmers(strings, k, min_mult))
    assert_same(jdb.get_all_kmers(js, k), tdb.get_all_kmers(ts, k))


def test_count_specific_kmers_and_its_duplicate_query_fault(world):
    """Equal counts; and the reference fault both packages keep: a query
    string given twice is counted twice (each occurrence adds to both
    list entries, which share one key)."""
    _, reads = world
    strings = {r: s for r, (s, _) in reads.items()}
    k = 5
    freq, _ = tdb.get_frequent_kmers(strings, k, 3)
    queries = list(freq)[:6] + [np.full(k, 5, np.int16).tobytes()]
    assert_same(jdb.count_specific_kmers(strings, k, queries),
                tdb.count_specific_kmers(strings, k, queries))
    q = queries[0]
    for mod in (jdb, tdb):
        once = mod.count_specific_kmers(strings, k, [q])[q]
        assert once == freq[q] > 0
        assert mod.count_specific_kmers(strings, k, [q, q])[q] == 2 * once
    with pytest.raises(ValueError):
        tdb.count_specific_kmers(strings, k + 1, queries)
    assert tdb.count_specific_kmers(strings, k, []) == {}


@pytest.mark.parametrize("k", [3, 8, 20])
def test_graph_contigs_map_reads_and_dot(world, k, tmp_path):
    _, reads = world
    js, ts = both(reads)
    jf, _ = jdb.get_frequent_kmers(js, k, 3)
    tf, _ = tdb.get_frequent_kmers(ts, k, 3)
    jg = jdb.MonoDeBruijnGraph(k, max_uniq_cov=30, min_uniq_len=k + 10)
    tg = tdb.MonoDeBruijnGraph(k, max_uniq_cov=30, min_uniq_len=k + 10)
    jg.add_kmers(jf, coverage=jf)
    tg.add_kmers(tf, coverage=tf)
    assert graph_state(jg) == graph_state(tg)
    assert_same(jg.get_contigs(), tg.get_contigs())
    assert graph_state(jg) == graph_state(tg)
    assert_same(jg.get_edges(), tg.get_edges())
    assert_same(jg.get_long_edges(), tg.get_long_edges())
    assert_same(jg.index_edges(), tg.index_edges())
    assert_same(jg.map_reads(js), tg.map_reads(ts))
    jg.write_dot(str(tmp_path / "j" / "g.dot"))
    tg.write_dot(str(tmp_path / "t" / "g.dot"))
    with open(tmp_path / "j" / "g.dot", "rb") as a, \
            open(tmp_path / "t" / "g.dot", "rb") as b:
        assert a.read() == b.read()
    eids = sorted(tg.edges)[:3]
    for path in ([e] for e in eids):
        assert_same(jg.get_edgepath2coords(path), tg.get_edgepath2coords(path))


def _dir_bytes(root):
    out = {}
    for r, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(r, n), "rb") as f:
                out[os.path.relpath(os.path.join(r, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def assembled(tmp_path_factory):
    """Both packages' iterative graph, mappings and scaffolds on the same
    error-corrected reads of a long-read symbol world."""
    syms, reads = symbol_world(SCAFFOLD_SEED, n_hor=60, n_reads=150,
                               gap_rate=0.01, rev=0.0, every=5)
    js, ts = both(reads)
    kw = dict(cut_min_length=10, hor_min_mult=10 ** 6, trim_ma_window=10)
    jec_reads = jec.error_correction(js, **kw)
    tec_reads = tec.error_correction(ts, **kw)
    out = {}
    for name, ec, sc in (("jax", jec_reads, jsc), ("port", tec_reads, tsc)):
        d = str(tmp_path_factory.mktemp(name))
        contigs, dbs = sc.iterative_graph(ec, min_k=3, max_k=20, min_mult=3,
                                          max_uniq_cov=200, min_uniq_len=20,
                                          outdir=d)
        db = dbs[20]
        mappings = db.map_reads(ec)
        scaffolds, paths = sc.scaffolding(db, mappings, 2, outdir=d)
        out[name] = dict(ec=ec, contigs=contigs, dbs=dbs, db=db,
                         mappings=mappings, scaffolds=scaffolds, paths=paths,
                         files=_dir_bytes(d))
    return syms, out


def test_iterative_graph_contigs_and_dot_files(assembled):
    _, out = assembled
    j, t = out["jax"], out["port"]
    assert_same(j["contigs"], t["contigs"])
    assert sorted(t["files"]) == sorted(
        [f"db_k{k}.dot" for k in range(3, 21)] + ["scaffold_graph.dot"])
    assert j["files"] == t["files"]
    for k in j["dbs"]:
        assert graph_state(j["dbs"][k]) == graph_state(t["dbs"][k])
    assert_same(j["mappings"], t["mappings"])
    jdb_, tdb_ = j["db"], t["db"]
    assert_same(jsc.get_complex_nodes(jdb_), tsc.get_complex_nodes(tdb_))
    strings = {r: m.syms for r, m in t["ec"].items()}
    assert_same(jsc.get_paths_thru_complex_nodes(j["dbs"][5], strings),
                tsc.get_paths_thru_complex_nodes(t["dbs"][5], strings))


def test_scaffolds_pseudounits_and_joins(assembled):
    syms, out = assembled
    j, t = out["jax"], out["port"]
    assert len(t["scaffolds"]) > 1, "the world must give scaffolds to join"
    assert_same((j["scaffolds"], j["paths"]), (t["scaffolds"], t["paths"]))
    assert_same(jsc.merge_scaffolds_with_paths(j["db"], j["scaffolds"],
                                               j["paths"], 5),
                tsc.merge_scaffolds_with_paths(t["db"], t["scaffolds"],
                                               t["paths"], 5))
    assert_same(jsc.merge_overlapping_scaffolds(j["scaffolds"], 5),
                tsc.merge_overlapping_scaffolds(t["scaffolds"], 5))
    jr = jsc.read2scaffolds(j["db"], j["paths"], j["mappings"], j["ec"])
    tr = tsc.read2scaffolds(t["db"], t["paths"], t["mappings"], t["ec"])
    assert_same(jr, tr)
    jc = jsc.cover_scaffolds_w_reads(jr, j["mappings"], j["scaffolds"],
                                     j["ec"], k=j["db"].k)
    tc = tsc.cover_scaffolds_w_reads(tr, t["mappings"], t["scaffolds"],
                                     t["ec"], k=t["db"].k)
    assert_same(jc, tc)
    for min_cov in (0, 3):
        assert_same(jsc.extract_read_pseudounits(jc, j["scaffolds"], j["ec"],
                                                 min_cov),
                    tsc.extract_read_pseudounits(tc, t["scaffolds"], t["ec"],
                                                 min_cov))
    for s in (syms[:50], np.array([0, 1, 0, 1, 2], np.int16), syms[:0]):
        assert_same(jsc.partition_pseudounits(s),
                    tsc.partition_pseudounits(s))


@pytest.mark.parametrize("seed", [0, 1])
def test_kmp_overlap(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 60).astype(np.int16)
    b = np.concatenate([a[-25:], rng.integers(0, 4, 30)]).astype(np.int16)
    for min_ov in (1, 10, 26):
        assert jsc._kmp_overlap(a, b, min_ov) == tsc._kmp_overlap(a, b,
                                                                  min_ov)
    assert tsc._kmp_overlap(a, b, 1) >= 25


def test_auto_join_fault_is_kept():
    """The reference fault both packages keep: `auto_join` is on by
    default, and the join takes any exact suffix-prefix overlap of at
    least join_min_overlap monomers, so two scaffolds that end and begin
    in the same 50-monomer repeat interlude (not one locus) are joined."""
    assert jconfig.MonoConfig().auto_join and tconfig.MonoConfig().auto_join
    assert dataclasses.asdict(jconfig.MonoConfig()) == \
        dataclasses.asdict(tconfig.MonoConfig())
    rng = np.random.default_rng(3)
    repeat = np.tile(np.arange(5, dtype=np.int16), 10)          # 50 long
    left = np.concatenate([rng.integers(0, 18, 80).astype(np.int16), repeat])
    right = np.concatenate([repeat, rng.integers(0, 18, 80).astype(np.int16)])
    for sc in (jsc, tsc):
        joined = sc.merge_overlapping_scaffolds([left, right], 50)
        assert len(joined) == 1 and len(joined[0]) == 210
    assert_same(jsc.merge_overlapping_scaffolds([left, right], 51),
                tsc.merge_overlapping_scaffolds([left, right], 51))


def _alt_world(tmp_path):
    """tests/test_sd_parser_alt.py's monomers and 7-column report."""
    rng = np.random.default_rng(3)
    names = [f"mono_{c}" for c in "ABCDEFG"]
    mono_fn = str(tmp_path / "monomers.fasta")
    write_seqs(mono_fn, {n: gen_random_seq(rng, 170 + i)
                         for i, n in enumerate(names)})
    rows, pos = [], 0
    for i, n in enumerate(["mono_A", "mono_B", "mono_C", "mono_D",
                           "mono_E", "mono_B"]):
        st = pos + (700 if i == 3 else 0)
        alt = "mono_F" if i == 4 else "None"
        rows.append(("read1", n, st, st + 170, -11.5, alt,
                     -20.0 if alt != "None" else "None"))
        pos = st + 175
    pos = 0
    for n in ["mono_C'", "mono_B'", "mono_A'", "mono_G'"]:
        rows.append(("read2", n, pos, pos + 168, -9.0, "None", "None"))
        pos += 172
    rows.append(("read3", "mono_A", 0, 170, -5.0, "mono_B", -5.5))
    rows.append(("read4", "mono_D", 0, 170, -5.0))       # 5 columns
    tsv_fn = str(tmp_path / "alt.tsv")
    with open(tsv_fn, "w") as f:
        for row in rows:
            print(*row, sep="\t", file=f)
    return mono_fn, tsv_fn


def test_sd_parser_alt(tmp_path, capsys):
    mono_fn, tsv_fn = _alt_world(tmp_path)
    j = jalt.parse_alt_sd_report(tsv_fn, mono_fn)
    t = talt.parse_alt_sd_report(tsv_fn, mono_fn)
    assert j.monomer_names_map == t.monomer_names_map
    assert {r: dataclasses.astuple(x) for r, x in j.records.items()} == \
        {r: dataclasses.astuple(x) for r, x in t.records.items()}
    assert list(t.records) == ["read1", "read2", "read3", "read4"]
    strings = t.get_monomer_strings()
    assert strings == j.get_monomer_strings()
    assert jalt.get_stats(strings) == talt.get_stats(strings)
    for compr in (False, True):
        assert jalt.get_ngap_symbols(strings, compr) == \
            talt.get_ngap_symbols(strings, compr)
    capsys.readouterr()
    jalt.main(["-i", tsv_fn, "-m", mono_fn])
    want = capsys.readouterr().out
    talt.main(["-i", tsv_fn, "-m", mono_fn])
    assert capsys.readouterr().out == want
    assert "ntranslations = 3" in want
