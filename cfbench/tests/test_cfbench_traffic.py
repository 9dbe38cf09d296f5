"""The one traffic generator: it repeats for a seed, differs across
seeds, keeps the set of sizes from seed to seed, and makes the stated
shapes (rel2's mean read length and centromeric share, cen6's 120x pool
of about 4,000 reads, 4,096-read calls)."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from cfbench.lib import spec, traffic

MIXES = ["rel2", "rel3_120x"]


def small(mix: dict) -> dict:
    """The mix at a hundredth of its reads (its shapes kept)."""
    mix = copy.deepcopy(mix)
    if "stream" in mix:
        mix["stream"]["reads"] = max(100, mix["stream"]["reads"] // 100)
    if "array" in mix:
        mix["array"]["hors"] = 8
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_repeats_and_differs(name):
    mix = small(spec.read_json(spec.path("traffic", f"{name}.json")))
    seed = 2 ** 31 + 12345
    a, b, c = (traffic.generate(mix, s) for s in (seed, seed, seed + 1))
    assert a.ids == b.ids and np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.labels, b.labels)
    assert not np.array_equal(a.codes[:4096], c.codes[:4096])
    if "array" not in mix:      # the array's reads are clipped to it
        assert np.array_equal(np.sort(a.lens), np.sort(c.lens))
    assert set(np.unique(a.codes)) <= {0, 1, 2, 3}


def test_rel2_shape():
    mix = spec.read_json(spec.path("traffic", "rel2.json"))
    rng = np.random.default_rng([0, 0])
    lens = traffic.lognormal_mix(rng, mix["stream"]["reads"],
                                 mix["stream"]["lengths"])
    assert 12_500 < lens.mean() < 15_500          # rel2: 155 Gbp / 11.1 M
    assert lens.min() >= 500 and lens.max() <= 100_000
    cfg = spec.read_json(spec.path("configs", "cenx_rel2.json"))
    pub = cfg["published"]
    share = pub["dxz1_array_bp"] / pub["genome_bp"]     # rel2's DXZ1 share
    assert mix["stream"]["tandem"]["share"] == pytest.approx(share, 1e-3)
    assert cfg["derived"]["centromeric_share"] == \
        mix["stream"]["tandem"]["share"]
    for seed in (7, 2 ** 31 + 7):
        got = traffic.generate(mix, seed)
        is_t = got.labels == traffic.LABELS["tandem"]
        assert is_t.sum() == 33
        assert got.lens[is_t].sum() / got.lens.sum() == pytest.approx(
            share, rel=0.2)
        assert abs(int(got.strands[is_t].sum()) * 2 - is_t.sum()) <= 1


def test_cen6_pool_and_calls():
    mix = spec.read_json(spec.path("traffic", "rel3_120x.json"))
    syms = mix["array"]["hors"] * 18
    n = int(mix["array"]["coverage"] * syms / mix["array"]["mean_monomers"])
    assert 3_900 <= n <= 4_100                    # 1,004 at 30x
    from cfbench.entries import decompose
    cfg = spec.read_json(spec.path("configs", "cen6_rel3.json"))
    assert cfg["run"]["batch_reads"] == 4096
    pool = [(f"c{i}", "ACGT") for i in range(n)]
    st = decompose.State(pool, np.full(n, 4), {}, cfg["run"], 4096, None,
                         np.zeros(0, np.int64))
    batch, idx = decompose._batch(st, 1)
    assert len(batch) == 4096 and len({r for r, _ in batch}) == 4096
    assert idx[0] == 4096 % n


def test_fasta_round_trip(tmp_path):
    mix = small(spec.read_json(spec.path("traffic", "rel2.json")))
    got = traffic.generate(mix, 3)
    fn = str(tmp_path / "r.fasta")
    got.write_fasta(fn)
    back = traffic.read_fasta(fn)
    assert list(back) == got.ids
    assert all(back[r] == got.text(i) for i, r in enumerate(got.ids))
