"""The port's native reader and 2-bit packers (`native/seqio.cpp` in the
port's library) against the JAX package's bindings: `native_iter_seqs`
gives the same (id, codes) records on FASTA and gzipped FASTQ with
descriptions, CRLF line ends, lowercase and IUPAC letters, empty records
and records longer than the reader's buffer; `native_pack2bit` and
`cf_encode_pack_row` give the JAX bindings' bytes and the port's numpy
`pack_2bit`'s, with N at every position mod 8. Both libraries are built
first and asserted loaded: without its library the JAX package returns
None."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from centroflye_tpu import native as jnative

from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.io.encoding import PAD, encode
from centroflye_tpu_torch.ops.fused_recruit import pack_2bit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IUPAC = "RYKMSWBDHVNrykmswbdhvn"


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None


def _records(seed=5, n=12):
    """Reads of 0 to 3,000 bases: plain, lowercase stretches, IUPAC
    letters, one empty."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = 0 if i == 3 else int(rng.integers(1, 3000))
        seq = "".join(rng.choice(list("ACGT"), L))
        if L > 40 and i % 2:
            a = int(rng.integers(0, L - 30))
            seq = seq[:a] + seq[a:a + 25].lower() + seq[a + 25:]
            b = int(rng.integers(0, L - 5))
            seq = seq[:b] + "".join(rng.choice(list(IUPAC), 4)) + seq[b + 4:]
        out.append((f"read{i}", seq))
    return out


def _write(fn, text):
    opener = gzip.open if fn.endswith(".gz") else open
    with opener(fn, "wt", newline="") as f:
        f.write(text)


def _fasta(records, eol="\n", width=None):
    parts = []
    for i, (r_id, seq) in enumerate(records):
        parts.append(f">{r_id}{' desc ' + str(i) if i % 3 else ''}{eol}")
        step = width or max(len(seq), 1)
        for a in range(0, len(seq), step):
            parts.append(seq[a:a + step] + eol)
    return "".join(parts)


def _fastq(records, eol="\n"):
    return "".join(f"@{r}{chr(9) + 'x' if i % 2 else ''}{eol}{s}{eol}+{eol}"
                   f"{'I' * len(s)}{eol}"
                   for i, (r, s) in enumerate(records))


def _read(module, fn, **kw):
    return [(r, c.tolist()) for r, c in module.native_iter_seqs(fn, **kw)]


@pytest.mark.parametrize("name,text", [
    ("plain.fasta", _fasta(_records())),
    ("wrapped.fasta.gz", _fasta(_records(), width=60)),
    ("crlf.fasta", _fasta(_records(), eol="\r\n", width=70)),
    ("reads.fastq.gz", _fastq(_records())),
    ("crlf.fastq", _fastq(_records(), eol="\r\n")),
    ("empty.fasta", ""),
    ("only_empty.fasta", ">a\n>b\n\n>c\nAC\n"),
])
def test_reader_equals_jax(tmp_path, name, text):
    fn = str(tmp_path / name)
    _write(fn, text)
    got = _read(tnative, fn)
    assert got == _read(jnative, fn)
    if name.startswith(("plain", "wrapped", "reads")):
        assert got == [(r, encode(s).tolist()) for r, s in _records()]


@pytest.mark.parametrize("max_len", [1, 64, 1000, 2999])
@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz"])
def test_records_past_the_buffer_as_jax(tmp_path, max_len, fmt):
    """A record longer than max_len: the JAX wrapper doubles its buffer
    but keeps the cap, so the record is skipped; the port does the
    same."""
    fn = str(tmp_path / f"r.{fmt}")
    recs = _records(seed=9)
    _write(fn, _fastq(recs) if fmt.startswith("fastq") else _fasta(recs))
    got = _read(tnative, fn, max_len=max_len)
    assert got == _read(jnative, fn, max_len=max_len)
    assert [r for r, _ in got] == [r for r, s in recs if len(s) <= max_len]


def test_reader_errors_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(tnative.native_iter_seqs(str(tmp_path / "missing.fasta")))
    fn = str(tmp_path / "long_id.fasta")
    _write(fn, ">ok\nACGT\n>" + "x" * 4096 + "\nACGT\n")
    for module in (tnative, jnative):
        it = module.native_iter_seqs(fn)
        assert next(it)[0] == "ok"
        with pytest.raises(RuntimeError, match="parse error"):
            next(it)


def _rows_with_n(seed, B, L):
    """Random codes with one N at every position mod 8 across the rows,
    and ragged lens (some N past a row's end)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    for r in range(B):
        if r % 3:
            codes[r, (r % 8)::8 * (1 + r % 5)] = PAD
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:2] = L
    return codes, lens


@pytest.mark.parametrize("L", [8, 64, 1024])
@pytest.mark.parametrize("use_lens", [False, True])
def test_pack2bit_equals_jax_and_numpy(L, use_lens):
    codes, lens = _rows_with_n(L, 40, L)
    lens = lens if use_lens else None
    got = tnative.native_pack2bit(codes, lens)
    want = jnative.native_pack2bit(codes, lens)
    ref = pack_2bit(codes, lens)
    for a, b, c in zip(got, want, ref):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    clean = np.where(codes >= 4, 0, codes).astype(np.int8)
    assert tnative.native_pack2bit(clean, lens)[1] is None


def test_pack2bit_keeps_the_shape_rule():
    codes = np.zeros((2, 12), np.int8)
    assert tnative.native_pack2bit(codes) is None
    assert jnative.native_pack2bit(codes) is None


def test_pack2bit_row_as_the_engine_calls_it():
    """One row at a time (rows = 1, a one-element lens array), as the
    engine packs the native reader's codes into its prescan batch."""
    codes, lens = _rows_with_n(3, 16, 256)
    fns = (tnative.get_pack2bit_row(), jnative.get_pack2bit_row())
    for r in range(len(codes)):
        outs = []
        for fn in fns:
            row = np.ascontiguousarray(codes[r])
            ln = lens[r:r + 1].copy()
            packed = np.zeros(64, np.uint8)
            mask = np.zeros(32, np.uint8)
            flag = fn(row.ctypes.data, 1, 256, ln.ctypes.data,
                      packed.ctypes.data, mask.ctypes.data)
            outs.append((flag, packed.tolist(), mask.tolist()))
        assert outs[0] == outs[1]
        p, m = pack_2bit(codes[r:r + 1], lens[r:r + 1])
        assert outs[0][:2] == (int(m is not None), p[0].tolist())


@pytest.mark.parametrize("SEG", [64, 1024])
def test_encode_pack_row_equals_jax_and_numpy(SEG):
    """cf_encode_pack_row on ASCII reads with lowercase, IUPAC and N at
    every position mod 8, segment by segment into a row buffer: the same
    bytes and flag as the JAX binding, and as numpy's encode + pad +
    pack_2bit; a segment row wider than out_bytes is refused."""
    rng = np.random.default_rng(SEG)
    fns = (tnative.get_encode_pack(), jnative.get_encode_pack())
    SEGQ = SEG // 4
    for i in range(24):
        L = int(rng.integers(0, 3 * SEG))
        seq = list("".join(rng.choice(list("ACGTacgt"), L)))
        if i % 2 and L:
            for pos in range(i % 8, L, 8 * (1 + i % 5)):
                seq[pos] = str(rng.choice(list(IUPAC)))
        seq = "".join(seq)
        raw = seq.encode("ascii")
        for st in range(0, max(L, 1), SEG - 16):
            ln = min(SEG, L - st)
            outs = []
            for fn in fns:
                buf = np.full(2 * SEGQ, 0xAA, np.uint8)   # stale bytes
                flag = fn(raw, st, ln, buf.ctypes.data, SEGQ)
                assert (buf[SEGQ:] == 0xAA).all()
                outs.append((flag, buf[:SEGQ].tolist()))
            assert outs[0] == outs[1]
            row = np.full((1, SEG), PAD, np.int8)
            row[0, :ln] = encode(seq[st:st + ln])
            p, m = pack_2bit(row, np.array([ln], np.int32))
            assert outs[0] == (int(m is not None), p[0].tolist())
    buf = np.zeros(4, np.uint8)
    assert fns[0](b"ACGT" * 5, 0, 20, buf.ctypes.data, 4) == -1


def test_reader_and_packers_with_jax_blocked(tmp_path):
    fn = str(tmp_path / "r.fastq.gz")
    _write(fn, _fastq(_records()))
    code = f"""
import sys
sys.modules["jax"] = None
import numpy as np
from centroflye_tpu_torch.native import (get_encode_pack, native_iter_seqs,
                                         native_pack2bit)
recs = list(native_iter_seqs({fn!r}))
assert len(recs) == 12 and recs[3][1].size == 0
codes = np.zeros((1, 16), np.int8)
assert native_pack2bit(codes)[1] is None
buf = np.zeros(4, np.uint8)
assert get_encode_pack()(b"ACGTNACG", 0, 8, buf.ctypes.data, 4) == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] == "centroflye_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
