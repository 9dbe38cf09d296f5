"""On-card smoke run of the PyTorch port (centroflye_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes (K1 two-strand, K2
one-strand and K3 threshold-k banded HW Myers, K4 per-row-query Myers, K5
a Myers column chunk from a carried state), then drives read
recruitment (stage 1 of cenX) on the real DXZ1 unit and a rel2-matched
read mix (its prescan batch filled by the native library, then once
more by numpy: every read's distances equal), its file CLI (the native
reader, on FASTA and on gzipped FASTQ), and the Myers op library's HW
entry points (K2, K3) on the exact tier's batches of that mix. K1 and
K2 are one wavefront kernel in instances of G = 8 and 32 lanes per
(row, strand): every instance is held against the plain version and
timed at 128 x 10240 (phases k1, k2) and at 2048 x 10240 (phase
myers_ops, where the
wrapper's instance is held against the plain version on exact-tier
batch 0), beside the instance the wrapper picks. K1c, the fused step's
survivor scorer (the passing rows only, each in exact column chunks),
is held against the plain version on whole rows and timed at the
pipeline's shape, 128 of 256 rows x 32768 with 11 and 128 rows passing,
at its own chunk width and others, beside K1 on whole rows (phase
k1c). K3 runs two passes (a prefix filter, then the survivors in column
windows): it is also held
against the plain version under forced plans and timed pass by pass at
each alpha of K3_ALPHAS. Each kernel is listed with its bound: the
larger of its operations over the card's INT32 rate at the maximum SM
clock and its bytes over the memory rate.

Then stages 2-4 of cenX on a simulated world of the production cenX
shape (make_world: a 1,500-unit DXZ1 array, reads at 52x, and 24 prefix
and 24 suffix reads with 52-90 kb of flank). Phase decomposition builds
the port's native Myers library (g++) and runs the unit decomposer on
the host: the boundary reads must classify as 24 prefix and 24 suffix
reads, and a sample of the world's records is held against its true
bounds. Phase unique_kmers drives stage 3 (rare k-mers, then the
distance-graph unique k-mers, through pipeline/cenx.run_unique_kmers;
plain PyTorch on the card, no kernel of its own): the card's output must
equal the CPU's on a cut of that world, also through the sweep's raw,
table and split paths at small capacities; on the cut and on the full
world the card's edges must equal a numpy count of sampled true k-mer
pairs; the full world prints its sizes, the strips of each sweep path,
phase seconds and peak device memory. Phase placement drives stage 4
(run_placement, its bulk scoring on the card, then
run_placement_validation) on the full world with stage 3's unique
k-mers: every bulk-scoring call must equal the other scorer on the card
(and the CPU on the first), read_positions.csv must be the JAX
package's (its digest, tools/placement_vs_jax.py), and the placed reads
must sit at their true unit and re-map there.

Then the whole cenX pipeline, `CenXPipeline.run`, through the port's
entry point. Phase cenx_fresh runs it with nothing resumed at
tests/test_e2e_cenx.py's small world (a 150-bp unit x 30), on the card
and on the CPU: every artifact must be equal, and a resumed run on the
card must return the same assembly. Phase cenx_pipeline runs it at the
full world from a reads file of about 275 Mbp (the world's records, its
reads over the array's ends, and main_path's background reads): stage 1
recruits on the card (K1c in the fused step), stages 2-4 resume from
the artifacts that phases unique_kmers and placement left, stages 5 (the
consensus unit, its k-mer count on the card) and 6 (per-position
polishing, the final polish) run. The recruited set must be every
world read and no background read, equal to the exact tier's; unit*
within 5 edits of DXZ1; the assembly within 0.5% of the simulated array over its span;
final_assembly.fasta and unit_star.fasta the JAX package's files
(ASSEMBLY_DIGEST, UNIT_STAR_DIGEST, tools/cenx_vs_jax.py).

Then cen6 (centroFlyeMono). Phase k4 holds K4, the per-row-query Myers
kernel of the monomer decomposer's lockstep step, against its plain
version in both of the decomposer's calls (each window's call chosen on
the card; every score of the first step) at two steps of it (the 18
D6Z1 monomers on both strands against 32 windows of 237 columns, and
against 1,024, a full lockstep batch) in every launch variant, and at
m = 1..256 and on exact quotient ties against the CPU;
phase k1 also holds K1 at the D6Z1 unit (m = 3222). Phase cen6_fresh
runs `MonoPipeline` (decomposer and run) at tests/test_mono_e2e.py's
small world on the card and on the CPU: every file equal. Phase
cen6_pipeline simulates benchmarks/bench_mono_cen6.py's 800-HOR array
and its ultra-long reads at 30x, recruits them with `recruit_file`
(D6Z1, 550) from a file that also holds main_path's reads, decomposes
them on K4 and assembles them: recruited = the array's reads = the
exact tier's set, call accuracy at least 0.99, every scaffold an exact
run of the array, pseudounits within 1% of it, and scaffold_0.fasta and
idb/ the JAX package's files (CEN6_SCAFFOLD_DIGEST, CEN6_IDB_DIGEST,
tools/cen6_vs_jax.py).

Last, multi-device execution with the card as every device of the mesh
(phase mesh): K5, the sequence-parallel tier's carry kernel, at every
lane group G, against its plain version on the whole carried state in
HW, SHW and NW modes, with its times by G and its one-warp issue floor
(the SASS of its column loop, tools/probe_myers_wavefront.py); the
engine's sharded fused step on main_path's mix (its distances); the
sequence-parallel tier on 8 reads of 100-400 kb (the single-device
engine's distances); recruit_file(distributed=True) in 2 gloo processes
(the single-process file, byte for byte); CenXPipeline and the cen6
decomposer on 2-shard meshes (the single-device card runs' files); and
the dry run, dryrun_multichip(4). K5 launches on no one-card path.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds. Any failed check exits
non-zero. Needs CUDA: without a card it fails and prints no result. The
last line is {"ok": true, "device": {...}}."""

import ast
import collections
import contextlib
import dataclasses
import gzip
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from centroflye_tpu_torch import DATA_DIR, native
from centroflye_tpu_torch.config import (COVERAGE, CentroFlyeConfig,
                                         ConsensusUnitConfig,
                                         KmerRecruitmentConfig, MonoConfig,
                                         PlacerConfig, PolisherConfig,
                                         RecruitmentConfig,
                                         UnitDecompositionConfig)
from centroflye_tpu_torch.io.encoding import (decode, encode, kmer_codes,
                                              revcomp, revcomp_str,
                                              string_to_kmer_code)
from centroflye_tpu_torch.io.fasta import (iter_seqs, read_seq, read_seqs,
                                           write_seqs)
from centroflye_tpu_torch.mono import pipeline as mono_pipeline
from centroflye_tpu_torch.mono.monostring import GAP
from centroflye_tpu_torch.mono.pipeline import MonoPipeline
from centroflye_tpu_torch.mono.string_decomposer import (
    MonomerDecomposer, MonomerDecomposerConfig)
from centroflye_tpu_torch.ops import _build, fused_recruit, scoring
from centroflye_tpu_torch.ops.myers import (MASK, build_peq, carry_init,
                                            int32_words, myers_carry_plain,
                                            myers_distance_batch,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (
    GROUPS, PERROW_CALLS, BandedRun, banded_plan, chunk_blocks,
    chunk_columns, chunk_windows, myers_carry, myers_hw_2strand,
    myers_hw_chunks,
    myers_hw_2strand_plain, myers_hw_v3, myers_hw_v3_banded,
    myers_hw_v3_plain, myers_perrow, myers_perrow_plain, perrow_queries,
    pick_group, threshold_hw)
from centroflye_tpu_torch.parallel import mesh as parallel_mesh
from centroflye_tpu_torch.parallel import seq_parallel
from centroflye_tpu_torch.parallel.dryrun import dryrun_multichip
from centroflye_tpu_torch.parallel.mesh import make_mesh
from centroflye_tpu_torch.pipeline.cenx import (CenXPipeline,
                                                run_placement,
                                                run_placement_validation,
                                                run_unique_kmers,
                                                save_decomposition)
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq,
                                                    simulate_tandem_repeat)
from centroflye_tpu_torch.ops.seed_filter import build_seed_bitmap
from centroflye_tpu_torch.stages import consensus
from centroflye_tpu_torch.stages.distance_graph import recruit_unique_kmers
from centroflye_tpu_torch.stages.polisher import _edit_distance, map_pos2read
from centroflye_tpu_torch.stages.read_placer import read_positions_file
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition,
                                                            UnitDecomposer)
from centroflye_tpu_torch.stages.recruitment import (RecruitmentEngine,
                                                     recruit_file,
                                                     segment_starts)
from centroflye_tpu_torch.utils.logging_utils import Recording, recording

HERE = os.path.dirname(os.path.abspath(__file__))
UNIT_FASTA = os.path.join(DATA_DIR, "DXZ1_rc.fasta")
N_READS = 8192            # the read mix of bench.py
CEN_FRACTION = 0.02
THRESHOLD = 350
BATCH_SIZE = 2048
SEG_LEN = 10240
K_BUDGET = 128            # rows K1 scores per fused step
K3_ALPHAS = (2.0, 2.5, 3.0)   # K3's prefix rows per row of k + 1, timed
PIPELINE_SEG_LEN = 32768  # recruit_file's segment length, the pipeline's
FUSED_EVERY = 4           # every 4th fused step's K1c call kept for the check
CAND_ROWS = 256           # candidate rows of a fused step (the engine's)
K1C_PASSING = (11, 128)   # passing rows of a fused step that K1c is timed at
K1C_CHUNKS = (2048, 4096, 8192)   # C that K1c is timed at besides its own
FUSED_STRIDE = 2          # make_fused_recruit's sampling stride
CLI_READS = 300
PALLAS = "centroflye_tpu/ops/myers_pallas_v3.py"
K1_REPLACES = f"{PALLAS}:575"
# K1c scores the fused step's survivors, which the JAX package scores
# whole with K1's pallas_call; it replaces none of its own
K1C_REPLACES = f"none (the survivors of {PALLAS}:575)"
# the fused step's seed filter and compaction: jnp in the JAX package
SF_REPLACES = ("none (centroflye_tpu/ops/fused_recruit.py's _packed_hits "
               "and argsort, jnp)")
K2_REPLACES = f"{PALLAS}:188"
K3_REPLACES = f"{PALLAS}:451"
K4_REPLACES = "centroflye_tpu/ops/myers.py:113"   # a jnp scan, no pallas_call
# K5 replaces the sequence-parallel tier's jnp chunk scan, no pallas_call
K5_REPLACES = "centroflye_tpu/parallel/seq_parallel.py:86"
CSRC = "centroflye_tpu_torch/csrc"
# bound: 32-bit integer operations per query word per text column (the
# add with its carry 2, d0 2, hp and hn 2, the two shifts 2, vp and vn 2,
# the Eq fetch 1), INT32 lanes per SM per clock, HBM bytes per second
OPS_PER_WORD_COLUMN = 11
INT32_LANES_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12
# stage 3's world: the shape of benchmarks/demo_cenx_production.py
# (production_1500u_c50_n5.json): DXZ1 units, their divergence, uniform
# read noise, read bases over the array; CUT_UNITS is the cut of the same
# world that the CPU runs too
WORLD_SEED = 7
N_UNITS = 1500
CUT_UNITS = 10
TRUTH_PAIRS = 4000        # true pairs truth_sample counts again
# the cut's clouds go through the sweep again at small capacities, on the
# card and the CPU: several raw strips, then coalesced table strips;
# table strips of many chunks (merge forests); strips sized past
# max_capacity, which split
CUT_SWEEPS = {"raw": dict(capacity=1 << 18),
              "table": dict(capacity=1 << 20, entry_chunk=1 << 16),
              "split": dict(capacity=1 << 18, dedup_hint=64,
                            max_capacity=1 << 18)}
DIV_RATE = 0.003
READ_NOISE = 0.055
READ_COVERAGE = 52
MIN_RECORD_LEN = 5000     # UnitDecompositionConfig.min_record_len
BOUNDARY_READS = 24       # prefix reads, and as many suffix reads
FLANK_BP = 200_000        # each end's flank (the JAX demo's)
# sha256 of read_positions.csv as the JAX package's ReadPlacer writes it
# for the full world's records and unique k-mers (CPU, on the card's
# machine): `JAX_PLATFORMS=cpu python3 tools/placement_vs_jax.py`
PLACEMENT_DIGEST = (
    "23748246ac3eb7c76415a459e7fb08a13b7a5c2b6b902af2553e197c5f211841")
DECOMP_SAMPLE = 500       # world records decomposed again in stage 2
# sha256 of final_assembly.fasta and cons_unit/unit_star.fasta as the JAX
# package writes them for the full world's pipeline, resumed after stage 4
# (on the card's machine): `python3 tools/cenx_vs_jax.py`
ASSEMBLY_DIGEST = (
    "1ff608a295ecf6e0e202d2798eb7be0f25d8bf0ecbf2d5313ae09fd354941170")
UNIT_STAR_DIGEST = (
    "72902ef4392863cc47a07c1db44202a5704d28cec330a7264e142520d3a36938")
# phase cenx_fresh: the world and config of tests/test_e2e_cenx.py
FRESH_SEED = 23
FRESH_UNIT = 150
FRESH_MULT = 30
FRESH_FLANK = 4000
FRESH_NOISE = 0.02
# cen6 (centroFlyeMono): the D6Z1 unit, its 18 monomers and the
# recruitment threshold of run_all_cen6.sh:17; the world of
# benchmarks/bench_mono_cen6.py: CEN6_HORS HOR copies with a variant
# monomer at one in CEN6_VARIANT_EVERY positions, reads of its ultra-long
# mix at CEN6_COVERAGE x (a cut from rel3's 120x, for the run's time
# limit) with CEN6_NOISE uniform noise (its part A), strands half and half
D6Z1_FASTA = os.path.join(DATA_DIR, "D6Z1.fasta")
D6Z1_MONOMERS = os.path.join(DATA_DIR, "D6Z1_monomers.fasta")
CEN6_THRESHOLD = 550
CEN6_SEED = 23
CEN6_HORS = 800
CEN6_VARIANT_EVERY = 24
CEN6_COVERAGE = 30
CEN6_MEAN_MONOMERS = 430.0    # the ultra-long mix's mean read, monomers
CEN6_NOISE = 0.08
CEN6_MIN_ACCURACY = 0.99
CEN6_MAX_DIVERGENCE = 0.01
# the JAX package's polishing/scaffold_0/scaffold_0.fasta and idb/ for
# this world (tools/cen6_vs_jax.py)
CEN6_SCAFFOLD_DIGEST = (
    "0715e64055eb6b2786bae7abce88153841c7d2f1a54439c9044da02c21aef894")
CEN6_IDB_DIGEST = (
    "6dcdda072e20bc3f8d88df8655c41effbb04368749a232ef4e220a97983de314")
K4_REPS = 50
# K4's shapes in phase k4: a step of 32 windows (the JAX package's batch)
# and of 1,024 (a full lockstep batch of cen6's reads)
K4_WINDOWS = (32, 1024)
K4_SAMPLE_EVERY = 16      # every 16th decomposer step timed on the device
SPIN_CYCLES = 400_000     # a spin of about 0.2 ms queued ahead of a timing
K4_SPIN_MAX = 64          # the sampled K4 launches' spin grows up to 12.8 ms
# phase mesh: meshes that repeat the one card; K5's checked chunk; the
# sequence-parallel tier's reads (LONG_READS of 100-400 kb, half tandem
# DXZ1 at 10% noise, half random); the processes of the multi-process run
MESH_SHARDS = 4
K5_ROWS = 8
K5_CHUNK = 2048
# K5's query lengths against the CPU's plain version, on two chunks of
# K5_SWEEP_CHUNK columns: the tap word and tap lane at every word and
# lane-group boundary; K5_LONG: one row of the tier's launch width;
# K5_WIDE: rows on either side of pick_group's switch, timed by G
K5_M_SWEEP = (1, 31, 32, 33, 64, 90, 2055, 3222, 4096)
K5_SWEEP_CHUNK = 300
K5_LONG = 98_304
K5_WIDE = (512, 2048)
LONG_READS = 8
LONG_LEN = (100_000, 400_000)
LONG_SEED = 31
DIST_PROCESSES = 2
DIST_TIMEOUT_S = 300
K4_SMALL_M = (1, 31, 32, 33, 64, 256)


def fresh_world():
    """tests/test_e2e_cenx.py's world, from the port's simulate: a random
    150-bp unit x 30 at 3% divergence between 4 kb flanks; three prefix
    reads, 2.2 kb internal reads every 500 bp (every third reverse
    complemented), two suffix reads and four background reads, all with
    2% noise. Returns (unit, the simulated repeat, {read id: seq})."""
    rng = np.random.default_rng(FRESH_SEED)
    unit = gen_random_seq(rng, FRESH_UNIT)
    sim = simulate_tandem_repeat(rng, unit, mult=FRESH_MULT, div_rate=0.03,
                                 flank_len=FRESH_FLANK)
    g = sim.flanked_tr
    tr_start, tr_end = FRESH_FLANK, FRESH_FLANK + len(sim.tr)
    reads = {}
    for pi, left in enumerate([3500, 3000, 2600]):
        reads[f"pre{pi}"] = g[tr_start - left:tr_start + 10 * FRESH_UNIT]
    i, start = 0, tr_start + 100
    while start + 2200 < tr_end - 100:
        seq = g[start:start + 2200]
        reads[f"int{i:02d}"] = revcomp_str(seq) if i % 3 == 1 else seq
        start += 500
        i += 1
    for si, right in enumerate([3500, 3000]):
        reads[f"suf{si}"] = g[tr_end - 10 * FRESH_UNIT:tr_end + right]
    for bi in range(4):
        reads[f"bg{bi}"] = gen_random_seq(rng, 3000)
    reads = {r: add_read_noise(rng, s, FRESH_NOISE) for r, s in reads.items()}
    return unit, sim, reads


def fresh_config():
    """tests/test_e2e_cenx.py's CentroFlyeConfig."""
    return CentroFlyeConfig(
        coverage=4,
        recruitment=RecruitmentConfig(threshold=int(FRESH_UNIT * 0.25),
                                      batch_size=16),
        decomposition=UnitDecompositionConfig(min_record_len=800),
        kmer_recruitment=KmerRecruitmentConfig(
            k=13, min_distance=1, max_distance=6, min_coverage=2,
            bottom=0.0, top=1e9),
        placer=PlacerConfig(min_cloud_kmer_freq=2, min_kmer_mult=2,
                            min_unit=2, min_inters=5,
                            prefix_threshold=1800, small_threshold=1000),
        consensus_unit=ConsensusUnitConfig(k=21),
        polisher=PolisherConfig(num_iters=2))


def sha256_of(fn):
    with open(fn, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def file_digests(root, skip=("metrics.json",)):
    """{relative path: sha256} of every file under root but `skip`."""
    return {os.path.relpath(os.path.join(r, n), root):
            sha256_of(os.path.join(r, n))
            for r, _, names in os.walk(root) for n in names if n not in skip}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel2_lengths(rng, n):
    """rel2-like lengths: ~88% regular long reads plus a 12% ultra-long
    component; overall mean ~14 kb (155 Gbp / 11.1 M reads)."""
    ul = rng.random(n) < 0.12
    lens = np.where(ul,
                    rng.lognormal(np.log(32_000), 0.45, n),
                    rng.lognormal(np.log(10_000), 0.5, n))
    return np.clip(lens, 500, 100_000).astype(np.int64)


def make_reads(unit: str, n_reads: int = N_READS):
    """bench.py's read mix from seed 0: 2% centromeric reads (tandem unit
    copies at 10% noise), the rest random sequence. Returns the reads and
    the ids of the centromeric ones."""
    rng = np.random.default_rng(0)
    lens = rel2_lengths(rng, n_reads)
    reads, cen = [], set()
    n_cen = max(1, int(n_reads * CEN_FRACTION))
    for i in range(n_reads):
        L = int(lens[i])
        if i % (n_reads // n_cen) == 0:
            n_copies = max(1, -(-L // len(unit)))
            seq = add_read_noise(rng, unit * n_copies, 0.10)[:L]
            cen.add(f"r{i:05d}")
        else:
            seq = gen_random_seq(rng, L)
        reads.append((f"r{i:05d}", seq))
    return reads, cen


def time_cuda(fn, reps, must_queue=False):
    """Mean device milliseconds of fn() over reps launches, by CUDA
    events. The launches queue behind a spin kernel, so the events time
    the device's work and not the host's launch latency, as long as fn
    does not wait for the card. must_queue: fail unless the host queued
    every launch before the device reached the first event (the spin
    grows fourfold, up to three times, until it did)."""
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES * reps
    for _ in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0.record()
        for _ in range(reps):
            fn()
        queued = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if queued or not must_queue:
            return t0.elapsed_time(t1) / reps
        spin *= 4
    check(False, "the host did not queue the timed launches ahead of the "
          "device")


def k1_case(rng, unit_codes, m, L, B, dev):
    """Ragged 2-strand batch on the card: lens 0 and < m, N runs, tandem
    rows on both strands, random rows."""
    rc = revcomp(unit_codes)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    reps = L // m + 1
    codes[0] = np.tile(unit_codes, reps)[:L]
    codes[1] = np.tile(rc, reps)[:L]
    for r in range(2, B, 16):           # noisy tandem rows, both strands
        src = unit_codes if r % 32 == 2 else rc
        row = np.tile(src, reps)[:L].copy()
        flip = rng.random(L) < 0.08
        row[flip] = rng.integers(0, 4, int(flip.sum()))
        codes[r] = row
    for r in range(3, B, 16):           # N runs
        s = int(rng.integers(0, L - 64))
        codes[r, s:s + 64] = 4
    codes[5] = 4                        # all N
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:3] = L
    lens[6] = 0
    lens[7] = m // 2
    lens[8] = m - 1
    args = (words_tensor(build_peq(unit_codes), dev),
            words_tensor(build_peq(rc), dev),
            torch.from_numpy(codes.T.copy()).to(dev),
            torch.from_numpy(lens).to(dev))
    return args


def k3_case(rng, unit_codes, L, B, dev):
    """Rows whose distances straddle THRESHOLD, on both strands: tandem
    copies of the unit or its reverse complement with substitution and
    indel noise from 5% to 30%; 3000-6000 random bases, then tandem
    copies (row m-1 enters the band late); tandem, 3000 random bases,
    tandem (row m-1 leaves the band and comes back); random rows, N runs,
    and lens 0, m-1 and m/2."""
    m = len(unit_codes)
    srcs = [decode(unit_codes) * (L // m + 2),
            decode(revcomp(unit_codes)) * (L // m + 2)]
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = np.full(B, L, np.int32)
    for r in range(B):
        src = srcs[(r // 4) % 2]
        if r % 4 == 0:
            seq = add_read_noise(rng, src, float(rng.uniform(0.05, 0.30)))
        elif r % 4 == 1:
            seq = (gen_random_seq(rng, int(rng.integers(3000, 6000)))
                   + add_read_noise(rng, src, 0.05))
        elif r % 8 == 2:
            seq = (add_read_noise(rng, src[:m], 0.05)
                   + gen_random_seq(rng, 3000) + add_read_noise(rng, src, 0.05))
        else:
            continue
        codes[r] = encode(seq)[:L]
    for r in range(3, B, 8):            # N runs
        s = int(rng.integers(0, L - 200))
        codes[r, s:s + 200] = 4
    lens[B - 1] = 0
    lens[B - 2] = m - 1
    lens[B - 3] = m // 2
    return (words_tensor(build_peq(unit_codes), dev),
            words_tensor(build_peq(revcomp(unit_codes)), dev),
            torch.from_numpy(codes.T.copy()).to(dev),
            torch.from_numpy(lens).to(dev))


def int32_ops_per_s():
    """The card's INT32 rate at its maximum SM clock (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM_CLOCK * mhz * 1e6


def myers_bound(lens, words, strands, rate):
    """(bound_ms, bound_by) of HW Myers over a batch: `words` query words
    per column of each row's lens columns, per strand, against the bytes
    (one code per column, the lens, the peq tables, two int32 outputs per
    row and strand)."""
    n = int(lens.sum())
    ops = OPS_PER_WORD_COLUMN * words * n * strands
    nbytes = n + 4 * lens.numel() + strands * (5 * 4 * words
                                               + 8 * lens.numel())
    op_ms, byte_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def max_abs_err(a, b):
    return max(int((a[k].cpu().long() - b[k].cpu().long()).abs().max())
               for k in a)


def timed_plain(fn):
    """(result, milliseconds) of a plain-version call on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_device():
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})
    return smi_line, kind


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    with open(path + ".log") as f:
        regs = [ln.split(":", 1)[1].strip() for ln in f
                if "registers" in ln]
    emit({"phase": "build", "library": os.path.relpath(path, HERE),
          "ptxas": regs, "seconds": time.perf_counter() - t0})


def phase_k1(unit_codes, dev, rate):
    """K1 against its plain version on the card at the fused step's shape
    (k_budget rows of one segment), the wrapper's instance and every G,
    then a small case also against the plain version on the CPU."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    m = len(unit_codes)
    args = k1_case(rng, unit_codes, m, SEG_LEN, K_BUDGET, dev)
    pf, pr, text_t, lens = args
    got = myers_hw_2strand(*args, m=m)
    # the plain version, myers_hw_2strand_plain, is one myers_hw_v3_plain
    # call per strand: timed per strand, so that K2 has its own plain time
    want_f, plain_f_ms = timed_plain(
        lambda: myers_hw_v3_plain(pf, text_t, lens, m=m))
    want_r, plain_r_ms = timed_plain(
        lambda: myers_hw_v3_plain(pr, text_t, lens, m=m))
    plain_ms = plain_f_ms + plain_r_ms
    want = {"dist_f": want_f["dist"], "end_f": want_f["end"],
            "dist_r": want_r["dist"], "end_r": want_r["end"]}
    err = max_abs_err(got, want)
    check(int(got["dist_f"][0]) == 0 and int(got["dist_r"][1]) == 0,
          "tandem rows must align exactly")
    check((int(got["dist_f"][6]), int(got["end_f"][6])) == (m, -1),
          "a row of length 0 gives (m, -1)")
    k1_ms = time_cuda(lambda: myers_hw_2strand(*args, m=m), reps=20)
    by_group = {}
    for G in GROUPS:
        err = max(err, max_abs_err(myers_hw_2strand(*args, m=m, group=G),
                                   want))
        by_group[G] = time_cuda(
            lambda: myers_hw_2strand(*args, m=m, group=G), reps=20)
    check(err == 0, f"K1 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")

    small_m = 90
    small = k1_case(rng, rng.integers(0, 4, small_m).astype(np.int8),
                    small_m, 256, 128, dev)
    want_s = myers_hw_2strand_plain(*small, m=small_m)
    cpu_s = myers_hw_2strand(*(a.cpu() for a in small), m=small_m)
    err_s = max_abs_err(want_s, cpu_s)
    for G in (None, *GROUPS):
        err_s = max(err_s, max_abs_err(
            myers_hw_2strand(*small, m=small_m, group=G), want_s))
    check(err_s == 0, "K1 != plain at m=90 (card or CPU)")
    bound_ms, bound_by = myers_bound(lens, pf.shape[1], 2, rate)
    group = pick_group(K_BUDGET, 2)
    d6z1 = k1_d6z1(rng, dev, rate)
    emit({"phase": "k1", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k1_ms": k1_ms, "group": group,
          "ms_by_group": by_group, "bound_ms": bound_ms,
          "plain_ms": plain_ms, "small_m90_max_abs_err": err_s,
          "d6z1": d6z1, "seconds": time.perf_counter() - t0})
    kernel = {"max_abs_err": max(err, err_s, d6z1["max_abs_err"]),
              "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "instances": {f"{K_BUDGET}x{SEG_LEN}": {
                  "group": group, "ms": k1_ms, "bound_ms": bound_ms,
                  "ms_by_group": by_group},
                  f"{K_BUDGET}x{SEG_LEN} D6Z1 m={d6z1['m']}": d6z1}}
    return kernel, {"args": args, "want": want, "plain_f_ms": plain_f_ms,
                    "small": small, "small_m": small_m}


def k1_d6z1(rng, dev, rate):
    """K1 at cen6's unit (D6Z1, m = 3222, W = 101) on a K_BUDGET x SEG_LEN
    batch of `k1_case`, the wrapper's instance and every G, against the
    plain version (one call, about as long as DXZ1's: its time is per
    column). -> the instance's fields."""
    codes = encode(read_seq(D6Z1_FASTA))
    m = len(codes)
    args = k1_case(rng, codes, m, SEG_LEN, K_BUDGET, dev)
    want, plain_ms = timed_plain(lambda: myers_hw_2strand_plain(*args, m=m))
    err = max_abs_err(myers_hw_2strand(*args, m=m), want)
    ms = time_cuda(lambda: myers_hw_2strand(*args, m=m), reps=20)
    by_group = {}
    for G in GROUPS:
        err = max(err, max_abs_err(myers_hw_2strand(*args, m=m, group=G),
                                   want))
        by_group[G] = time_cuda(
            lambda: myers_hw_2strand(*args, m=m, group=G), reps=20)
    check(err == 0, f"K1 != plain at {K_BUDGET}x{SEG_LEN}, D6Z1 m={m}")
    bound_ms, _ = myers_bound(args[3], args[0].shape[1], 2, rate)
    return {"m": m, "words": args[0].shape[1], "max_abs_err": err,
            "ms": ms, "group": pick_group(K_BUDGET, 2),
            "ms_by_group": by_group, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def k1c_case(rng, unit_codes, dev):
    """A fused step's survivor scoring at the pipeline's shape: CAND_ROWS
    rows of PIPELINE_SEG_LEN columns (`k1_case`'s rows, their N made
    bases, as the engine's candidate rows hold none; every row full but
    a few short ones), packed on the card, and the order of a random
    permutation of them -> (K1c's arguments but n_pass and the outputs,
    the (L, B) codes)."""
    m = len(unit_codes)
    pf, pr, text_t, _ = k1_case(rng, unit_codes, m, PIPELINE_SEG_LEN,
                                CAND_ROWS, "cpu")
    codes = text_t.t().numpy()
    codes = np.where(codes < 4, codes,
                     rng.integers(0, 4, codes.shape)).astype(np.int8)
    lens = np.full(CAND_ROWS, PIPELINE_SEG_LEN, np.int32)
    lens[6], lens[7], lens[8] = 0, m // 2, 3 * m
    packed, _ = fused_recruit.pack_2bit(codes, lens)
    order = torch.from_numpy(rng.permutation(CAND_ROWS)).to(dev)
    args = (int32_words(pf.to(dev)), int32_words(pr.to(dev)),
            torch.from_numpy(packed).to(dev), None,
            torch.from_numpy(lens).to(dev), order[:K_BUDGET])
    return args, torch.from_numpy(codes.T.copy()).to(dev)


def phase_k1c(dev, rate):
    """K1c, the fused step's survivor scorer, at the pipeline's shape
    (K_BUDGET of CAND_ROWS rows x PIPELINE_SEG_LEN columns) with
    K1C_PASSING rows passing, on DXZ1 and D6Z1: its distances equal the
    plain version on whole rows (at its own C and each of K1C_CHUNKS);
    timed at each C, beside K1 on the same passing rows whole (the
    scorer's launch before K1c: rows that failed were scored too, so at
    K_BUDGET rows) and beside the bound of the passing rows' work."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    out = {}
    for name, fasta in (("DXZ1", UNIT_FASTA), ("D6Z1", D6Z1_FASTA)):
        unit_codes = encode(read_seq(fasta))
        m = len(unit_codes)
        args, text_t = k1c_case(rng, unit_codes, dev)
        words_f, words_r, _, _, lens, top = args
        pf, pr = (w.long() & MASK for w in (words_f, words_r))
        want, plain_ms = timed_plain(lambda: plain_both_strands(
            pf, pr, text_t[:, top].contiguous(), lens[top], m=m))
        k1_ms = time_cuda(lambda: myers_hw_2strand(
            pf, pr, text_t[:, top].contiguous(), lens[top], m=m), reps=5)
        for n_pass in K1C_PASSING:
            n_t = torch.tensor([n_pass], dtype=torch.int32, device=dev)
            rows = top[:n_pass]
            by_c, err = {}, 0
            own = chunk_columns(m, PIPELINE_SEG_LEN, n_pass,
                                chunk_blocks(dev))
            for C in (None, *K1C_CHUNKS):
                dist = [torch.full((CAND_ROWS,), m, dtype=torch.int32,
                                   device=dev) for _ in range(2)]
                myers_hw_chunks(*args, n_t, *dist, m=m, C=C)
                err = max(err, max_abs_err(
                    {"dist_f": dist[0][rows], "dist_r": dist[1][rows]},
                    {k: want[k][:n_pass] for k in ("dist_f", "dist_r")}))
                untouched = torch.ones(CAND_ROWS, dtype=torch.bool,
                                       device=dev)
                untouched[rows] = False
                err = max(err, int((dist[0][untouched] != m).sum()
                                   + (dist[1][untouched] != m).sum()))
                by_c["own" if C is None else C] = time_cuda(
                    lambda: myers_hw_chunks(*args, n_t, *dist, m=m, C=C),
                    reps=10)
            check(err == 0, f"K1c != plain at {n_pass} of {K_BUDGET} rows "
                  f"x {PIPELINE_SEG_LEN}, {name} m={m}")
            out[f"{n_pass}x{PIPELINE_SEG_LEN} {name} m={m}"] = {
                "m": m, "rows": n_pass, "candidate_rows": CAND_ROWS,
                "chunk_columns": own, "chunks_a_row": len(chunk_windows(
                    PIPELINE_SEG_LEN, m, own)),
                "max_abs_err": err, "ms": by_c["own"], "ms_by_chunk": by_c,
                "k1_whole_rows_ms": k1_ms, "plain_ms": plain_ms,
                "bound_ms": myers_bound(lens[rows], pf.shape[1], 2,
                                        rate)[0]}
    emit({"phase": "k1c", "instances": out,
          "seconds": time.perf_counter() - t0})
    first = out[f"{K1C_PASSING[0]}x{PIPELINE_SEG_LEN} DXZ1 m="
                f"{len(read_seq(UNIT_FASTA))}"]
    return {"max_abs_err": max(i["max_abs_err"] for i in out.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "library_ms": None,
            "instances": out}


def seed_filter_work(lens, seed_k, stride, nw):
    """(live words, bitmap probes, bytes) of the seed filter on rows of
    `lens`: the words holding a window, the windows at the sampled
    phases, and the bytes read once (the live words, one 4-byte bitmap
    word a probe) and written (the bundle)."""
    lens = np.asarray(lens, np.int64)
    live = np.clip((lens - seed_k) // 16 + 1, 0, nw)
    probes = sum(np.clip((lens - seed_k - o) // 16 + 1, 0, nw).sum()
                 for o in range(0, 16, stride))
    nbytes = 4 * int(live.sum()) + 4 * int(probes) + 4 * (3 * len(lens) + 1)
    return int(live.sum()), int(probes), nbytes


def phase_seed_filter(dev):
    """The fused step's seed filter and compaction (`csrc/seed_filter.cu`)
    at the pipeline's shape, CAND_ROWS x PIPELINE_SEG_LEN (`k1c_case`'s
    rows), with recruitment's settings, on DXZ1 and D6Z1, with rel2-like
    row lengths and with every row full: the kernel's bundle and pass
    order equal its plain version's on the card; each one's device ms,
    and the bound (bytes over HBM: the live words and a bitmap word a
    probe, read once)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    cfg = RecruitmentConfig()
    nw = PIPELINE_SEG_LEN // 16
    out = {}
    for name, fasta in (("DXZ1", UNIT_FASTA), ("D6Z1", D6Z1_FASTA)):
        unit = read_seq(fasta)
        _, text_t = k1c_case(rng, encode(unit), dev)
        codes = np.ascontiguousarray(text_t.t().cpu().numpy())
        bm = int32_words(words_tensor(
            build_seed_bitmap(unit, cfg.seed_k, le=True), dev))
        kw = dict(m=len(unit), seed_k=cfg.seed_k, stride=FUSED_STRIDE,
                  min_hits=max(1, cfg.min_seed_hits // FUSED_STRIDE),
                  k_budget=K_BUDGET)
        for lengths in ("rel2", "full"):
            lens = np.full(CAND_ROWS, PIPELINE_SEG_LEN, np.int32)
            if lengths == "rel2":
                lens = np.minimum(rel2_lengths(rng, CAND_ROWS),
                                  PIPELINE_SEG_LEN).astype(np.int32)
            packed, _ = fused_recruit.pack_2bit(codes, lens)
            args = (bm, torch.from_numpy(packed).to(dev),
                    torch.from_numpy(lens).to(dev))
            got = fused_recruit.seed_filter_compact(*args, **kw)
            want = fused_recruit.seed_filter_compact_plain(*args, **kw)
            err = int(not (torch.equal(got[0], want[0])
                           and torch.equal(got[1], want[1])))
            check(err == 0, f"the seed filter kernel != plain at "
                  f"{CAND_ROWS}x{PIPELINE_SEG_LEN}, {name}, {lengths}")
            ms = time_cuda(lambda: fused_recruit.seed_filter_compact(
                *args, **kw), reps=50)
            plain_ms = time_cuda(lambda: fused_recruit.seed_filter_compact_plain(
                *args, **kw), reps=10)
            live, probes, nbytes = seed_filter_work(lens, cfg.seed_k,
                                                    FUSED_STRIDE, nw)
            out[f"{CAND_ROWS}x{PIPELINE_SEG_LEN} {name} {lengths}"] = {
                "m": len(unit), "n_pass": int(got[0][-1]),
                "mean_len": float(lens.mean()), "live_words": live,
                "probes": probes, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "seed_filter", "instances": out,
          "seconds": time.perf_counter() - t0})
    first = out[f"{CAND_ROWS}x{PIPELINE_SEG_LEN} DXZ1 rel2"]
    return {"max_abs_err": max(i["max_abs_err"] for i in out.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "instances": out}


def phase_k2(k1, k1_ms, m, rate):
    """K2 with peq_f, then peq_r, on phase k1's batch, the wrapper's
    instance and every G: each equals the matching strand of the plain
    result phase k1 computed. Then m = 90 against the plain version on
    the CPU."""
    t0 = time.perf_counter()
    pf, pr, text_t, lens = k1["args"]
    want = k1["want"]
    err = 0
    for G in (None, *GROUPS):
        for s, peq in (("f", pf), ("r", pr)):
            got = myers_hw_v3(peq, text_t, lens, m=m, group=G)
            err = max(err, max_abs_err(
                got, {"dist": want[f"dist_{s}"], "end": want[f"end_{s}"]}))
    check(err == 0, f"K2 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")
    k2_ms = time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m), reps=20)
    by_group = {G: time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m,
                                                 group=G), reps=20)
                for G in GROUPS}

    small_m = k1["small_m"]
    spf, spr, stext, slens = k1["small"]
    err_s = 0
    for peq in (spf, spr):
        cpu = myers_hw_v3(peq.cpu(), stext.cpu(), slens.cpu(), m=small_m)
        for G in (None, *GROUPS):
            got = myers_hw_v3(peq, stext, slens, m=small_m, group=G)
            err_s = max(err_s, max_abs_err(got, cpu))
    check(err_s == 0, "K2 != CPU plain at m=90")
    bound_ms, bound_by = myers_bound(lens, pf.shape[1], 1, rate)
    group = pick_group(K_BUDGET, 1)
    emit({"phase": "k2", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k2_ms": k2_ms, "group": group,
          "ms_by_group": by_group, "bound_ms": bound_ms, "k1_ms": k1_ms,
          "plain_ms": k1["plain_f_ms"], "small_m90_max_abs_err": err_s,
          "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k2_ms,
            "plain_ms": k1["plain_f_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "instances": {f"{K_BUDGET}x{SEG_LEN}": {
                "group": group, "ms": k2_ms, "bound_ms": bound_ms,
                "ms_by_group": by_group}}}


def k3_bound(lens, k, rate):
    """K3's bound: the query rows that every column's band must hold,
    the first k + 1 (a cell of row i <= k has a score <= k), as words;
    the rows a band holds beyond them near a match are not counted."""
    return myers_bound(lens, -(-(k + 1) // 32), 1, rate)


def k3_plans(m, L):
    """Forced K3 plans (prefix_rows, window): the wrapper's own, pass 1
    only (r0 = m), a prefix r0 < m, and windows in both passes."""
    r0 = 64 if m > 64 else m
    S = max(64, L // 7)
    return [(None, None), (m, None), (r0, None), (m, S), (r0, S)]


def k3_passes(peq, text_t, lens, m, k, want, reps):
    """K3's plan on one batch at each alpha: r0, S and windows of each
    pass, the survivors, the problems, each pass's ms alone and the
    wrapper's (CUDA events). Every run's outputs must equal `want`."""
    L, B = text_t.shape
    out = {}
    for alpha in K3_ALPHAS:
        r0 = banded_plan(m, k, L, B, alpha=alpha).r0
        run = BandedRun(peq, text_t, lens, m=m, k=k, prefix_rows=r0)
        run.pass1()
        run.pass2()
        pass_ms = [time_cuda(run.pass1, reps)]
        if run.plan.pass2 is not None:
            pass_ms.append(time_cuda(run.pass2, reps))
        check(max_abs_err(run.result(), want) == 0,
              f"K3 pass by pass != plain at alpha {alpha}")
        plan = run.plan
        passes = [p for p in (plan.pass1, plan.pass2) if p is not None]
        out[alpha] = {
            "r0": plan.r0, "survivors": run.survivors,
            "S": [p.S for p in passes], "windows": [p.windows for p in passes],
            "problems": [p.problems for p in passes], "pass_ms": pass_ms,
            "ms": time_cuda(lambda: myers_hw_v3_banded(
                peq, text_t, lens, m=m, k=k, prefix_rows=r0), reps)}
    return out


def phase_k3(unit_codes, dev, k1_ms, k2_ms, rate):
    """K3 at k = THRESHOLD against its plain version on its own
    128 x 10240 DXZ1 batch (one plain run per strand), with the
    wrapper's plan and forced ones (`k3_plans`), then small cases at m =
    90, 300 and 1500, k in {0, 20, m}, every forced plan, and random rows
    that leave pass 1 no survivor, against the plain version on the CPU.
    Prints K3's plan, survivors and ms per pass at each alpha, beside K1's
    and K2's ms on the same batch."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    m = len(unit_codes)
    pf, pr, text_t, lens = k3_case(rng, unit_codes, SEG_LEN, K_BUDGET, dev)
    err, plain_ms, in_band, wants = 0, [], [], []
    for peq in (pf, pr):
        got = myers_hw_v3_banded(peq, text_t, lens, m=m, k=THRESHOLD)
        want, ms = timed_plain(lambda: threshold_hw(
            myers_hw_v3_plain(peq, text_t, lens, m=m), m=m, k=THRESHOLD))
        err = max(err, max_abs_err(got, want))
        for prefix_rows, window in k3_plans(m, SEG_LEN):
            err = max(err, max_abs_err(myers_hw_v3_banded(
                peq, text_t, lens, m=m, k=THRESHOLD, prefix_rows=prefix_rows,
                window=window), want))
        plain_ms.append(ms)
        wants.append(want)
        in_band.append(int((got["dist"] <= THRESHOLD).sum()))
    check(err == 0, f"K3 != plain at {K_BUDGET}x{SEG_LEN}, k={THRESHOLD}")
    check(min(in_band) >= 8 and max(in_band) <= K_BUDGET - 8,
          f"K3 rows do not straddle k: {in_band} in band")
    k3_ms = time_cuda(lambda: myers_hw_v3_banded(pf, text_t, lens, m=m,
                                                 k=THRESHOLD), reps=20)
    k1_here = time_cuda(lambda: myers_hw_2strand(pf, pr, text_t, lens, m=m),
                        reps=20)
    k2_here = time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m), reps=20)
    passes = k3_passes(pf, text_t, lens, m, THRESHOLD, wants[0], reps=20)

    err_s, forced = 0, 0
    for small_m, L in ((90, 256), (300, 512), (1500, 3000)):
        codes = rng.integers(0, 4, small_m).astype(np.int8)
        args = k3_case(rng, codes, L, 128, dev)
        cpu_args = [a.cpu() for a in args]
        for peq, cpu_peq in ((args[0], cpu_args[0]), (args[1], cpu_args[1])):
            unbanded = myers_hw_v3_plain(cpu_peq, *cpu_args[2:], m=small_m)
            for k in (0, 20, small_m):
                want = threshold_hw(unbanded, m=small_m, k=k)
                got = myers_hw_v3_banded(peq, *args[2:], m=small_m, k=k)
                err_s = max(err_s, max_abs_err(got, want))
                for prefix_rows, window in k3_plans(small_m, L):
                    err_s = max(err_s, max_abs_err(myers_hw_v3_banded(
                        peq, *args[2:], m=small_m, k=k,
                        prefix_rows=prefix_rows, window=window), want))
                    forced += 1
    # random rows: no 64-row prefix within k = 0, so no pass-2 problem
    rand = rng.integers(0, 4, (256, 3000)).astype(np.int8)
    rand_args = (args[0], torch.from_numpy(rand.T.copy()).to(dev),
                 torch.full((256,), 3000, dtype=torch.int32, device=dev))
    want = myers_hw_v3_banded(*(a.cpu() for a in rand_args), m=1500, k=0)
    zero = {}
    for window in (None, 200):
        run = BandedRun(*rand_args, m=1500, k=0, prefix_rows=64,
                        window=window)
        run.pass1()
        run.pass2()
        zero[str(window)] = run.survivors
        err_s = max(err_s, max_abs_err(run.result(), want))
    check(set(zero.values()) == {0}, f"random rows survived pass 1: {zero}")
    check(err_s == 0, "K3 != CPU plain at m = 90, 300 or 1500")
    bound_ms, bound_by = k3_bound(lens, THRESHOLD, rate)
    emit({"phase": "k3", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "k": THRESHOLD, "max_abs_err": err, "rows_in_band": in_band,
          "k3_ms": k3_ms, "bound_ms": bound_ms,
          "k2_ms_same_batch": k2_here,
          "k1_ms_same_batch": k1_here, "k2_ms_k1_batch": k2_ms,
          "k1_ms_k1_batch": k1_ms, "plain_ms": plain_ms,
          "passes_by_alpha": passes, "forced_plans_small": forced,
          "zero_survivors": zero,
          "small_max_abs_err": err_s, "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k3_ms,
            "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "instances": {f"{K_BUDGET}x{SEG_LEN}": {
                "ms": k3_ms, "bound_ms": bound_ms, "k2_ms": k2_here,
                "passes_by_alpha": passes}}}


def fill_seconds(reads, seg_len, overlap, batch, native_fill):
    """Host seconds of the prescan batch's fill alone, as the engine does
    it for string reads: native, each segment row encoded and 2-bit
    packed in place (cf_encode_pack_row); numpy, each read encoded, its
    segments copied into an int8 batch, a full batch packed
    (pack_2bit)."""
    segq = seg_len // 4
    t = time.perf_counter()
    if native_fill:
        enc_pack = native.get_encode_pack()
        rows = np.zeros((batch, segq), np.uint8)
        base, row = rows.ctypes.data, 0
        for _, seq in reads:
            raw = seq.encode("ascii")
            for st in segment_starts(len(raw), seg_len, overlap):
                enc_pack(raw, st, min(seg_len, len(raw) - st),
                         base + row * segq, segq)
                row = (row + 1) % batch
    else:
        codes_b = np.full((batch, seg_len), 4, np.int8)
        lens, row = np.zeros(batch, np.int32), 0
        for _, seq in reads:
            codes = encode(seq)
            for st in segment_starts(len(codes), seg_len, overlap):
                ln = min(seg_len, len(codes) - st)
                codes_b[row, :ln] = codes[st:st + ln]
                codes_b[row, ln:] = 4
                lens[row] = ln
                row += 1
                if row == batch:
                    fused_recruit.pack_2bit(codes_b, lens)
                    row = 0
        lens[row:] = 0
        fused_recruit.pack_2bit(codes_b, lens)
    return time.perf_counter() - t


def hold_fills(unit, cfg, reads, results, dev, seg_len=SEG_LEN):
    """main_path's mix through the engine's two fills, in turns (numpy,
    numpy, native, after the counted native run): every read's
    (dist_fwd, dist_rc) under the numpy fill (native_fill=False) must
    equal the native fill's `results`. Returns each run's seconds and
    each fill's host seconds alone (`fill_seconds`)."""
    want = [(r.r_id, r.dist_fwd, r.dist_rc) for r in results]
    engines = {f: RecruitmentEngine(unit, cfg, seg_len=seg_len, device=dev,
                                    native_fill=f) for f in (False, True)}
    for eng in engines.values():
        list(eng.run(reads[:272]))                # warm-up
    runs = {False: [], True: []}
    for native_fill in (False, False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = list(engines[native_fill].run(reads))
        torch.cuda.synchronize()
        runs[native_fill].append(time.perf_counter() - t)
        got = [(r.r_id, r.dist_fwd, r.dist_rc) for r in got]
        bad = [a for a, b in zip(got, want) if a != b]
        check(got == want, f"the {'native' if native_fill else 'numpy'} "
              f"fill differs from the native fill's run on {len(bad)} "
              f"reads: {bad[:5]}")
    eng = engines[True]
    fills = {f: [fill_seconds(reads, eng.seg_len, eng.overlap, eng.batch,
                              f) for _ in range(2)] for f in (False, True)}
    return runs, fills


def phase_main_path(unit, dev):
    t0 = time.perf_counter()
    reads, cen = make_reads(unit)
    t_make = time.perf_counter() - t0
    total_bp = sum(len(s) for _, s in reads)
    cfg = RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE)
    engine = RecruitmentEngine(unit, cfg, seg_len=SEG_LEN, device=dev)
    list(engine.run(reads[:272]))                 # warm-up
    torch.cuda.synchronize()

    for key in ("k1", "k1c", "sf"):
        KERNELS[key].launches = 0
    t_run = time.perf_counter()
    results = list(engine.run(reads))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    launches = {k: KERNELS[k].launches for k in ("k1", "k1c", "sf")}
    runs, fills = hold_fills(unit, cfg, reads, results, dev)
    runs[True].insert(0, dt)

    check(launches["k1c"] > 0, "the main path's fused step launched K1c "
          "no time")
    check(launches["sf"] == launches["k1c"], f"the seed filter kernel "
          f"launched {launches['sf']} times in {launches['k1c']} fused steps")
    check([r.r_id for r in results] == [r for r, _ in reads],
          "results out of input order")
    recruited = {r.r_id for r in results if r.recruited}
    missed = sorted(cen - recruited)
    extra = sorted(recruited - cen)
    check(not missed, f"centromeric reads not recruited: {missed[:10]}")
    check(not extra, f"background reads recruited: {extra[:10]}")

    t_exact = time.perf_counter()
    exact = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE,
                                prefilter=False),
        seg_len=SEG_LEN, device=dev)
    batches = []                 # the exact tier's (codes, lens) batches
    score_batch = exact.distances

    def capture(codes, lens):
        batches.append((codes, lens.copy()))
        return score_batch(codes, lens)
    exact.distances = capture
    exact_results = list(exact.run(reads))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t_exact
    exact_set = {r.r_id for r in exact_results if r.recruited}
    check(exact_set == recruited,
          f"prefiltered != exact tier: {sorted(exact_set ^ recruited)[:10]}")
    distances = {"prefilter": [(r.r_id, r.dist_fwd, r.dist_rc)
                               for r in results],
                 "exact": [(r.r_id, r.dist_fwd, r.dist_rc)
                           for r in exact_results]}
    emit({"phase": "main_path", "reads": len(reads), "mbp": total_bp / 1e6,
          "cen_reads": len(cen), "recruited": len(recruited),
          "exact_tier_reads": len(reads), "exact_tier_equal": True,
          "reads_per_s": len(reads) / dt, "mbp_per_s": total_bp / dt / 1e6,
          "run_seconds": dt, "k1_launches": launches["k1"],
          "k1c_launches": launches["k1c"], "sf_launches": launches["sf"],
          "fills_equal": True,
          "fills": {("native" if f else "numpy"): {
              "run_seconds": runs[f],
              "reads_per_s": [len(reads) / x for x in runs[f]],
              "fill_host_seconds": fills[f]} for f in (True, False)},
          "make_reads_seconds": t_make, "exact_tier_seconds": exact_s,
          "seconds": time.perf_counter() - t0})
    return reads, recruited, launches, batches, exact.overlap, distances


def phase_myers_ops(unit, reads, recruited, batches, overlap, dev, rate):
    """The Myers op library's HW entry points on the exact tier's
    batches of the main path's mix (BATCH_SIZE x SEG_LEN, both strands):
    K2 equals K1's strand, K3 at k = THRESHOLD equals K1's strand
    thresholded, and the reads K3 would recruit are the engine's. Then,
    with the counts read, the wrapper's K1 and K2 on batch 0 equal the
    plain version (one plain call per strand), every G instance of K1
    and K2 on every batch equals K1's strands, and each is timed on
    batch 0."""
    t0 = time.perf_counter()
    m = len(unit)
    uc = encode(unit)
    pf = words_tensor(build_peq(uc), dev)
    pr = words_tensor(build_peq(revcomp(uc)), dev)
    seg_read, seg_len = [], []    # exact-tier row -> read, segment length
    for i, (_, seq) in enumerate(reads):
        for st in segment_starts(len(seq), SEG_LEN, overlap):
            seg_read.append(i)
            seg_len.append(min(SEG_LEN, len(seq) - st))
    check(len(batches) == -(-len(seg_read) // BATCH_SIZE),
          "exact-tier batches do not cover the segments")
    read_min = np.full(len(reads), m, np.int64)
    in_band = 0

    myers_hw_v3.launches = 0
    myers_hw_v3_banded.launches = 0
    t_run = time.perf_counter()
    for b, (codes, lens) in enumerate(batches):
        rows = slice(b * BATCH_SIZE, (b + 1) * BATCH_SIZE)
        n = len(seg_read[rows])
        check(list(lens[:n]) == seg_len[rows] and not lens[n:].any(),
              f"exact-tier batch {b} is not the segments in read order")
        text_t = torch.from_numpy(codes).to(dev).t().contiguous()
        lens_t = torch.from_numpy(lens).to(dev)
        k1 = myers_hw_2strand(pf, pr, text_t, lens_t, m=m)
        dmin = None
        for s, peq in (("f", pf), ("r", pr)):
            one = {"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]}
            k2 = myers_hw_v3(peq, text_t, lens_t, m=m)
            k3 = myers_hw_v3_banded(peq, text_t, lens_t, m=m, k=THRESHOLD)
            check(max_abs_err(k2, one) == 0, f"K2 != K1 ({s}), batch {b}")
            check(max_abs_err(k3, threshold_hw(one, m=m, k=THRESHOLD)) == 0,
                  f"K3 != K1 thresholded ({s}), batch {b}")
            d = k3["dist"][:n].cpu().numpy()
            dmin = d if dmin is None else np.minimum(dmin, d)
        in_band += int((dmin <= THRESHOLD).sum())
        np.minimum.at(read_min, seg_read[rows], dmin)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"k2": myers_hw_v3.launches, "k3": myers_hw_v3_banded.launches}
    check(launches["k2"] > 0 and launches["k3"] > 0,
          f"the Myers op path launched K2 or K3 no time: {launches}")
    k3_set = {reads[i][0] for i in np.flatnonzero(read_min <= THRESHOLD)}
    check(k3_set == recruited,
          f"K3's recruited set != the engine's: {sorted(k3_set ^ recruited)[:10]}")

    text0 = torch.from_numpy(batches[0][0]).to(dev).t().contiguous()
    lens0 = torch.from_numpy(batches[0][1]).to(dev)
    k1 = myers_hw_2strand(pf, pr, text0, lens0, m=m)
    plain_ms, plain_err, plain_in_band = {}, 0, 0
    for s, peq in (("f", pf), ("r", pr)):
        want, plain_ms[s] = timed_plain(
            lambda: myers_hw_v3_plain(peq, text0, lens0, m=m))
        plain_err = max(
            plain_err,
            max_abs_err({"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]},
                        want),
            max_abs_err(myers_hw_v3(peq, text0, lens0, m=m), want))
        plain_in_band += int((want["dist"] <= THRESHOLD).sum())
    check(plain_err == 0, "K1 or K2 != plain on exact-tier batch 0")
    check(plain_in_band > 0, "exact-tier batch 0 holds no row within k")
    k3_want = threshold_hw({"dist": k1["dist_f"], "end": k1["end_f"]}, m=m,
                           k=THRESHOLD)
    k3_passes0 = k3_passes(pf, text0, lens0, m, THRESHOLD, k3_want, reps=5)

    err = 0
    for codes, lens in batches:
        text_t = torch.from_numpy(codes).to(dev).t().contiguous()
        lens_t = torch.from_numpy(lens).to(dev)
        k1 = myers_hw_2strand(pf, pr, text_t, lens_t, m=m)
        for G in GROUPS:
            err = max(err, max_abs_err(
                myers_hw_2strand(pf, pr, text_t, lens_t, m=m, group=G), k1))
            for s, peq in (("f", pf), ("r", pr)):
                err = max(err, max_abs_err(
                    myers_hw_v3(peq, text_t, lens_t, m=m, group=G),
                    {"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]}))
    check(err == 0, "a G instance of K1 or K2 != K1 on an exact-tier batch")

    ms = {"k1_ms": time_cuda(lambda: myers_hw_2strand(pf, pr, text0, lens0,
                                                      m=m), reps=5),
          "k2_ms": time_cuda(lambda: myers_hw_v3(pf, text0, lens0, m=m),
                             reps=5),
          "k3_ms": time_cuda(lambda: myers_hw_v3_banded(
              pf, text0, lens0, m=m, k=THRESHOLD), reps=5)}
    by_group = {f"k{k}": {G: time_cuda(lambda: fn(G), reps=5)
                          for G in GROUPS}
                for k, fn in (
                    (1, lambda G: myers_hw_2strand(pf, pr, text0, lens0,
                                                   m=m, group=G)),
                    (2, lambda G: myers_hw_v3(pf, text0, lens0, m=m,
                                              group=G)))}
    W = pf.shape[1]
    bounds = {"k1": myers_bound(lens0, W, 2, rate)[0],
              "k2": myers_bound(lens0, W, 1, rate)[0],
              "k3": k3_bound(lens0, THRESHOLD, rate)[0]}
    groups = {"k1": pick_group(BATCH_SIZE, 2), "k2": pick_group(BATCH_SIZE, 1)}
    emit({"phase": "myers_ops", "batches": len(batches),
          "segments": len(seg_read), "shape": [BATCH_SIZE, SEG_LEN],
          "k": THRESHOLD, "segments_in_band": in_band,
          "recruited": len(k3_set), "k3_set_equal": True,
          "batch0_vs_plain_max_abs_err": plain_err,
          "batch0_rows_in_band_vs_plain": plain_in_band,
          "plain_ms_batch0": plain_ms, "instances_max_abs_err": err,
          "launches": launches, "run_seconds": run_s,
          "ms_at_2048_rows_batch0": ms, "ms_by_group_batch0": by_group,
          "bound_ms_batch0": bounds, "group": groups,
          "batch0_sum_lens": int(lens0.sum()),
          "k3_passes_by_alpha_batch0": k3_passes0,
          "seconds": time.perf_counter() - t0})
    shape = f"{BATCH_SIZE}x{SEG_LEN}"
    plain = {"k1": plain_ms["f"] + plain_ms["r"], "k2": plain_ms["f"]}
    instances = {k: {shape: {"group": groups[k], "ms": ms[f"{k}_ms"],
                             "plain_ms": plain[k], "bound_ms": bounds[k],
                             "ms_by_group": by_group[k]}}
                 for k in ("k1", "k2")}
    instances["k3"] = {shape: {"ms": ms["k3_ms"], "bound_ms": bounds["k3"],
                               "plain_ms": plain["k2"], "k2_ms": ms["k2_ms"],
                               "passes_by_alpha": k3_passes0}}
    return launches, instances


IUPAC = "RYKMSWBDHVNrykmswbdhvn"


def odd_reads(reads, seed=5):
    """Every other read, from the first, with a 25-base lowercase stretch
    and four IUPAC letters. Returns the reads and, by id, the form the
    native reader gives each (upper case, every letter but ACGT an N)."""
    rng = np.random.default_rng(seed)
    out, native_form = [], {}
    for i, (r_id, seq) in enumerate(reads):
        if i % 2 == 0 and len(seq) > 40:
            a = int(rng.integers(0, len(seq) - 30))
            seq = seq[:a] + seq[a:a + 25].lower() + seq[a + 25:]
            b = int(rng.integers(0, len(seq) - 5))
            seq = seq[:b] + "".join(rng.choice(list(IUPAC), 4)) + seq[b + 4:]
        out.append((r_id, seq))
        native_form[r_id] = decode(encode(seq))
    return out, native_form


def phase_cli(reads, recruited, dev):
    """recruit_file on main_path's first CLI_READS reads, as FASTA: the
    reads main_path recruited, in order; then the same reads as gzipped
    FASTQ with descriptions, lowercase stretches and IUPAC letters
    (`odd_reads`): the FASTA run's file with those reads in the native
    reader's form (IUPAC letters as N)."""
    t0 = time.perf_counter()
    sub = reads[:CLI_READS]
    want = [(r_id, seq) for r_id, seq in sub if r_id in recruited]
    check(want, "the CLI slice holds no recruited read")
    odd, native_form = odd_reads(sub)
    with tempfile.TemporaryDirectory() as tmp:
        reads_fn = os.path.join(tmp, "reads.fasta")
        fastq_fn = os.path.join(tmp, "reads.fastq.gz")
        out_fn = os.path.join(tmp, "recruited.fasta")
        out_q = os.path.join(tmp, "recruited_fastq.fasta")
        with open(reads_fn, "w") as f:
            for r_id, seq in sub:
                f.write(f">{r_id}\n{seq}\n")
        with gzip.open(fastq_fn, "wt") as f:
            for r_id, seq in odd:
                f.write(f"@{r_id} run=1 ch=7\n{seq}\n+\n{'5' * len(seq)}\n")
        t = time.perf_counter()
        n = recruit_file(UNIT_FASTA, reads_fn, out_fn, THRESHOLD,
                         batch_size=BATCH_SIZE, seg_len=SEG_LEN,
                         device=dev)
        fasta_s = time.perf_counter() - t
        t = time.perf_counter()
        n_q = recruit_file(UNIT_FASTA, fastq_fn, out_q, THRESHOLD,
                           batch_size=BATCH_SIZE, seg_len=SEG_LEN,
                           device=dev)
        fastq_s = time.perf_counter() - t
        got = list(iter_seqs(out_fn))
        got_q = list(iter_seqs(out_q))
    check(n == len(want) and got == want,
          f"CLI output {[r for r, _ in got]} != {[r for r, _ in want]}")
    odd_kept = [r for r, s in got if native_form[r] != s]
    check(n_q == n and got_q == [(r, native_form[r]) for r, _ in got],
          f"the FASTQ.gz run's file differs from the FASTA run's: "
          f"{[r for r, _ in got_q]} against {[r for r, _ in got]}")
    check(odd_kept, "no recruited read holds an IUPAC letter")
    emit({"phase": "cli", "reads": len(sub), "recruited": n,
          "fastq_gz_equal": True, "recruited_with_iupac": len(odd_kept),
          "fasta_seconds": fasta_s, "fastq_gz_seconds": fastq_s,
          "seconds": time.perf_counter() - t0})


def rel2_length_mix(rng, n):
    """The read lengths of benchmarks/demo_cenx_production.py: 25% around
    75 kb, 75% around 11 kb, clipped to 3-200 kb."""
    ul = rng.random(n) < 0.25
    lens = np.where(ul, rng.lognormal(np.log(75_000), 0.35, n),
                    rng.lognormal(np.log(11_000), 0.6, n))
    return np.clip(lens, 3_000, 200_000).astype(np.int64)


def add_noise(rng, src, rate=READ_NOISE):
    """Uniform noise at `rate` on a code array, in bulk: deletion,
    insertion before the base, substitution, a third each (the model of
    pipeline/simulate.add_read_noise). Returns the noisy codes and `cum`,
    where cum[i] is where source base i's span (an insertion before it,
    then the base) starts in the output and cum[-1] is the output's
    length."""
    src = src.copy()
    r = rng.random(src.size)
    third = rate / 3
    dele, ins = r < third, (r >= third) & (r < 2 * third)
    sub = (r >= 2 * third) & (r < rate)
    src[sub] = (src[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    emit = np.where(dele, 0, np.where(ins, 2, 1))
    cum = np.concatenate([[0], np.cumsum(emit)])
    out = np.empty(int(cum[-1]), np.int8)
    out[cum[:-1][~dele] + ins[~dele]] = src[~dele]
    out[cum[:-1][ins]] = rng.integers(0, 4, int(ins.sum()))
    return out, cum


@dataclasses.dataclass
class World:
    """The simulated cenX world of `make_world`."""

    arr: np.ndarray           # the tandem array's codes
    unit_len: int
    dec: Decomposition        # the records standing in for stage 2
    n_reads: int              # reads over the array, records or not
    read_bp: int
    u0: dict                  # record or boundary read -> its first unit
    # the reads over the array's ends: (r_id, seq), and each read's true
    # whole-unit boundaries in its coordinates
    boundary: list
    boundary_bounds: dict


def make_world(unit, n_units, seed=WORLD_SEED):
    """Stages 2-4's input, in bulk numpy: a tandem array of n_units
    copies of `unit` with DIV_RATE substitutions, reads of the rel2 mix
    at READ_COVERAGE x over it with uniform READ_NOISE (`add_noise`), and
    the decomposition records that stand in for stage 2: each read's
    whole units, strand +, bounds at the simulated unit boundaries
    carried through the noise. Then, from a second generator (seed + 1,
    so the records above do not move), the reads over the array's ends
    that benchmarks/demo_cenx_production.py's flanked genome has: a
    random FLANK_BP flank at each end; BOUNDARY_READS prefix and as many
    suffix reads shaped as its extra ones, 52-90 kb of flank before
    (after) 4-10 whole units at the array's start (end); and the
    rel2-mix reads at READ_COVERAGE that cross an end from its flank
    with MIN_RECORD_LEN of whole units (ids lft*, rgt*), all with the
    same noise. Only the decomposer turns these into records."""
    rng = np.random.default_rng(seed)
    m = len(unit)
    arr = np.tile(encode(unit), n_units)
    n_mut = int(rng.binomial(arr.size, DIV_RATE))
    pos = rng.choice(arr.size, n_mut, replace=False)
    arr[pos] = (arr[pos] + rng.integers(1, 4, n_mut)) % 4
    lens = rel2_length_mix(rng, int(READ_COVERAGE * arr.size / 3_000))
    lens = np.minimum(lens, arr.size)
    n_reads = int(np.searchsorted(np.cumsum(lens),
                                  READ_COVERAGE * arr.size)) + 1
    lens = lens[:n_reads]
    starts = rng.integers(0, arr.size - lens + 1)
    u0 = -(-starts // m)                       # first whole unit
    nu = (starts + lens) // m - u0             # whole units in the read
    keep = nu * m >= MIN_RECORD_LEN
    u0, nu = u0[keep], nu[keep]
    # the records' bases, concatenated, with the noise applied in bulk
    out, cum = add_noise(rng, np.concatenate(
        [arr[a * m:(a + n) * m] for a, n in zip(u0, nu)]))
    records, first, g0 = {}, {}, 0
    for i, (a, n) in enumerate(zip(u0, nu)):
        b = cum[g0 + np.arange(n + 1) * m]
        seq = decode(out[b[0]:b[-1]])
        r_id = f"w{i:05d}"
        records[r_id] = DecompRecord(r_id, len(seq), "+", 0, len(seq), seq,
                                     (b - b[0]).astype(np.int32))
        first[r_id] = int(a)
        g0 += n * m
    dec = Decomposition(records, {r: [(0, rec.r_len, "+")]
                                  for r, rec in records.items()},
                        {r: rec.r_len for r, rec in records.items()}, [])
    rng = np.random.default_rng(seed + 1)
    left, right = (rng.integers(0, 4, FLANK_BP).astype(np.int8)
                   for _ in range(2))
    # (r_id, source codes, where its first whole unit starts, whole units,
    # the first whole unit's index in the array)
    reads = []
    for kind in ("pre", "suf"):
        for j in range(BOUNDARY_READS):
            f = int(rng.integers(52_000, 90_000))
            into = int(rng.integers(4, 10))
            if kind == "pre":
                reads.append((f"pre{j:02d}", np.concatenate(
                    [left[FLANK_BP - f:], arr[:into * m]]), f, into, 0))
            else:
                reads.append((f"suf{j:02d}", np.concatenate(
                    [arr[arr.size - into * m:], right[:f]]), 0, into,
                    n_units - into))
    # the rel2-mix reads at READ_COVERAGE that cross an end of the array
    # from a FLANK_BP flank, as the JAX demo's reads over its flanked
    # genome do: from each side, reads starting (ending) uniformly in the
    # flank, kept if they hold MIN_RECORD_LEN of whole units
    for kind in ("lft", "rgt"):
        side = rel2_length_mix(rng, int(READ_COVERAGE * FLANK_BP / 3_000))
        side = side[:int(np.searchsorted(np.cumsum(side),
                                         READ_COVERAGE * FLANK_BP)) + 1]
        f = rng.integers(1, FLANK_BP + 1, side.size)   # flank bases held
        inside = np.minimum(side - f, arr.size)
        for j in np.flatnonzero(inside // m * m >= MIN_RECORD_LEN):
            fj, ij = int(f[j]), int(inside[j])
            if kind == "lft":
                reads.append((f"lft{j:03d}", np.concatenate(
                    [left[FLANK_BP - fj:], arr[:ij]]), fj, ij // m, 0))
            else:
                a = -(-(arr.size - ij) // m)
                reads.append((f"rgt{j:03d}", np.concatenate(
                    [arr[arr.size - ij:], right[:fj]]),
                    a * m - (arr.size - ij), n_units - a, a))
    boundary, true_bounds = [], {}
    for r_id, src, at, nu, a in reads:
        noisy, cum = add_noise(rng, src)
        boundary.append((r_id, decode(noisy)))
        true_bounds[r_id] = cum[at + np.arange(nu + 1) * m]
        first[r_id] = a
    return World(arr, m, dec, n_reads, int(lens.sum()), first, boundary,
                 true_bounds)


class PhaseLog(Recording):
    """A recording of the spans and counters of the port's stage-3 and
    stage-4 modules. `sums`: each span's seconds and each counter's
    total by name. A span records its self time, so "rare" and "sweep"
    get the spans inside them added back: both are printed whole, as
    their phases' wall seconds."""

    WHOLE = {"rare": ("rare_occ", "rare_count_merge", "rare_readback"),
             "sweep": ("sweep_plan",)}

    @property
    def sums(self) -> dict:
        out = {k: self.seconds(k) for k in self.spans}
        out.update(self.counters)
        for k, inner in self.WHOLE.items():
            if k in out:
                out[k] += sum(out.get(i, 0.0) for i in inner)
        return out


def read_artifacts(outdir, c):
    out = []
    for name in (f"unique_kmers_min_edge_cov_{c}.txt",
                 f"unique_edges_min_edge_cov_{c}.txt"):
        with open(os.path.join(outdir, "recruited_unique_kmers", name),
                  "rb") as f:
            out.append(f.read())
    return out


def truth_sample(arr, m, cfg, res, n_pairs=TRUTH_PAIRS):
    """Stage 3's edges against an independent count on a sample of true
    unit-to-unit k-mer pairs: (i, j) with both k-mers once in the
    simulated array and rare, i in array unit u and j in unit u + 1. Per
    pair, numpy counts from the clouds the sweep ran on how often j sits
    d units after i in one record, for every d <= max_distance; the edge
    (i, j, 1) must be in the result, with that count, exactly when the
    rule keeps it (count >= min_coverage and count / all distances >=
    rel_threshold). Also the share of unique k-mers once in the array."""
    once, once_pos = once_in_array(arr, cfg.k)
    in_rare = np.isin(once, res.rare)
    tensor = res.clouds
    check(tensor.shape[1] < 1000, "truth sample: a record of 1000 units")
    # each rare k-mer's (record, unit instance) occurrences, as r * 1000 + t
    r, t, _ = np.nonzero(tensor >= 0)
    vals = tensor[tensor >= 0]
    order = np.argsort(vals, kind="stable")
    occ_keys = (r.astype(np.int64) * 1000 + t)[order]
    bounds = np.searchsorted(vals[order], np.arange(len(res.rare) + 1))
    by_unit = {}
    for i, uu in zip(np.searchsorted(res.rare, once[in_rare]),
                     once_pos[in_rare] // m):
        by_unit.setdefault(int(uu), []).append(int(i))
    cand = [(i, j) for uu in sorted(by_unit) if uu + 1 in by_unit
            for i in by_unit[uu] for j in by_unit[uu + 1]]
    pick = np.random.default_rng(0).choice(
        len(cand), min(n_pairs, len(cand)), replace=False)
    e = res.edges
    got = {(i, j): f for i, j, d, f in zip(e.i.tolist(), e.j.tolist(),
                                           e.dist.tolist(), e.freq.tolist())
           if d == 1}
    counts, want, bad = [], 0, []
    for i, j in (cand[p] for p in pick):
        a = occ_keys[bounds[i]:bounds[i + 1]]
        b = occ_keys[bounds[j]:bounds[j + 1]]
        diff = b[None, :] - a[:, None]
        same = (b[None, :] // 1000) == (a[:, None] // 1000)
        d = diff[same & (diff >= cfg.min_distance)
                 & (diff <= cfg.max_distance)]
        by_d = np.bincount(d, minlength=2)
        c1, total = int(by_d[1]), int(by_d.sum())
        counts.append(c1)
        keep = c1 >= cfg.min_coverage and c1 >= cfg.rel_threshold * total
        want += keep
        if (got.get((i, j)) == c1) != keep or (not keep and (i, j) in got):
            bad.append((i, j, c1, total, got.get((i, j))))
    out = {"once_in_array": len(once), "once_and_rare": int(in_rare.sum()),
           "pairs": len(pick), "edges_by_rule": want, "differ": len(bad),
           "count_hist": np.bincount(np.minimum(np.asarray(counts, int),
                                                12), minlength=13).tolist(),
           "examples": bad[:5],
           "unique_once_in_array": float(np.isin(res.codes, once).mean())}
    check(len(pick) > 0 and want > 0 and not bad,
          f"truth sample: the edges differ from the count: {out}")
    return out


def merge_decompositions(a, b):
    return Decomposition({**a.records, **b.records},
                         {**a.positions_all, **b.positions_all},
                         {**a.read_lens, **b.read_lens},
                         a.discarded + b.discarded)


def phase_unique_kmers(unit, dev, world, world_s, boundary_dec, outdir):
    """Stage 3 (rare k-mers, then the distance-graph unique k-mers) through
    `run_unique_kmers`. First the cut world (its records only) on the
    card and on the CPU: the rare codes, the unique codes and the edges
    (i, j, d, freq; the edge file) must be identical. Then the full
    world's records with the decomposed boundary reads' on the card.
    Both print their sizes and the strips each sweep path took, and both
    hold the card's edges against `truth_sample`; the full world also
    prints its phase seconds and peak device memory. The full world's
    artifacts, and the Decomposition it ran on (decomposition.json), stay
    in `outdir`, where phase cenx_pipeline resumes from them. Returns the
    full world's result and its Decomposition, for phase placement."""
    t0 = time.perf_counter()
    cfg = KmerRecruitmentConfig()

    def run(dec, d, outdir):
        log = PhaseLog()
        t = time.perf_counter()
        with recording(log):
            res = run_unique_kmers(dec, cfg, COVERAGE, outdir, device=d)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, log.sums

    def sizes(res, sums):
        check(len(res.codes) > 0 and np.isin(res.codes, res.rare).all(),
              "no unique k-mer, or one that is not rare")
        return {"rare_kmers": len(res.rare), "unique_kmers": len(res.codes),
                "edges": len(res.edges.i),
                "pair_observations": sums["pair_obs"],
                **{k: sums.get(k, 0) for k in (
                    "strips", "raw_strips", "table_strips",
                    "host_planned_strips", "strip_splits",
                    "strips_coalesced")}}

    cut_world = make_world(unit, CUT_UNITS)
    cut_arr, cut_dec = cut_world.arr, cut_world.dec
    cut = {"units": CUT_UNITS, "reads": cut_world.n_reads}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            out = os.path.join(tmp, where)
            res, secs, sums = run(cut_dec, d, out)
            runs[where] = res, read_artifacts(out, cfg.min_coverage), sums
            cut[f"{where}_seconds"] = secs
    (cpu, cpu_files, _), (card, card_files, sums) = runs["cpu"], runs["card"]
    check(np.array_equal(cpu.rare, card.rare),
          "cut world: rare k-mers on the card != on the CPU")
    check(cpu_files == card_files,
          "cut world: unique k-mers or edges on the card != on the CPU")
    cut.update(sizes(card, sums), identical=True,
               truth=truth_sample(cut_arr, len(unit), cfg, card))
    # the sweep's other paths on the cut's clouds, the card against the
    # CPU and against the run above
    cut["sweeps"] = {}
    for name, kw in CUT_SWEEPS.items():
        got, secs = [], {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            log = PhaseLog()
            t = time.perf_counter()
            with recording(log):
                got.append(recruit_unique_kmers(
                    card.clouds, card.n_units, card.rare, cfg, device=d,
                    **kw))
            secs[f"{where}_seconds"] = time.perf_counter() - t
        for codes, e in got:
            check(np.array_equal(codes, card.codes) and all(
                np.array_equal(getattr(e, f), getattr(card.edges, f))
                for f in ("i", "j", "dist", "freq")),
                f"cut world, sweep {name}: the card or the CPU differs")
        cut["sweeps"][name] = {k: log.sums.get(k, 0) for k in (
            "strips", "raw_strips", "table_strips", "strip_splits",
            "strips_coalesced")} | secs
    del runs, cpu, card

    arr, read_bp = world.arr, world.read_bp
    dec = merge_decompositions(world.dec, boundary_dec)
    save_decomposition(dec, os.path.join(outdir, "decomposition.json"))
    torch.cuda.reset_peak_memory_stats()
    res, run_s, sums = run(dec, dev, outdir)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(outdir, "recruited_unique_kmers",
                           f"unique_kmers_min_edge_cov_"
                           f"{cfg.min_coverage}.txt")) as f:
        from_file = [string_to_kmer_code(ln.strip()) for ln in f]
    check(from_file == res.codes.tolist(),
          "full world: the k-mer artifact differs from the result")
    t = time.perf_counter()
    truth = truth_sample(arr, len(unit), cfg, res)
    truth_s = time.perf_counter() - t
    seconds = {k: sums[k] for k in (
        "rare", "rare_occ", "rare_count_merge", "rare_readback", "clouds",
        "sweep", "sweep_plan", "artifacts")}
    seconds["sweep_device"] = sums["sweep"] - sums["sweep_plan"]
    emit({"phase": "unique_kmers", "units": N_UNITS,
          "div_rate": DIV_RATE, "noise": READ_NOISE,
          "coverage_config": COVERAGE, "reads": world.n_reads,
          "records": len(dec.records),
          "boundary_records": len(boundary_dec.records),
          "mbp": read_bp / 1e6,
          "record_mbp": sum(r.r_len for r in dec.records.values()) / 1e6,
          "read_coverage": read_bp / arr.size, **sizes(res, sums),
          "unique_once_in_array": truth.pop("unique_once_in_array"),
          "truth": truth, "truth_seconds": truth_s,
          "world_seconds": world_s, "run_seconds": run_s,
          "phase_seconds": seconds, "max_memory_allocated": peak,
          "cut_world": cut, "seconds": time.perf_counter() - t0})
    return res, dec


def bound_errors(dec, truth):
    """Records of `dec` against true unit boundaries (r_id -> boundary
    positions in the read): how many reads gave a record, how many on
    strand + with the true unit count, and over those the median and
    largest |boundary - true boundary| in bp."""
    found = [r for r in truth if r in dec.records]
    right = [r for r in found if dec.records[r].strand == "+"
             and dec.records[r].n_units == len(truth[r]) - 1]
    err = np.concatenate([np.abs(dec.records[r].bounds.astype(np.int64)
                                 + dec.records[r].r_st - truth[r])
                          for r in right] or [np.zeros(0, np.int64)])
    return {"reads": len(truth), "records": len(found),
            "true_unit_count": len(right),
            "bound_err_median_bp": float(np.median(err)) if err.size else None,
            "bound_err_max_bp": int(err.max()) if err.size else None}


def phase_decomposition(unit, world):
    """Stage 2 on the host: the port's native Myers library builds (g++)
    and loads; `UnitDecomposer` turns the reads over the array's ends
    into records (the 24 shaped prefix and 24 suffix reads must classify
    so, and the flank-crossing reads are counted against the class
    their flank gives), and decomposes a seeded sample of DECOMP_SAMPLE
    of the world's records; each set is held against the true bounds
    `make_world` knows. Returns the boundary reads' Decomposition."""
    t0 = time.perf_counter()
    lib = native.build()
    native.load_library()
    build_s = time.perf_counter() - t0
    decomposer = UnitDecomposer(unit, UnitDecompositionConfig())
    t = time.perf_counter()
    bdec = decomposer.decompose(world.boundary)
    boundary_s = time.perf_counter() - t
    pcfg = PlacerConfig()
    classes = bdec.classify(pcfg.prefix_threshold, pcfg.small_threshold)
    got = {r: name for name, ids in zip(("prefix", "internal", "suffix"),
                                        classes) for r in ids}
    seqs = dict(world.boundary)
    shaped = [r for r in seqs if r[:3] in ("pre", "suf")]
    crossing = [r for r in seqs if r not in shaped]

    def flank_class(r):
        b = world.boundary_bounds[r]
        if r.startswith("lft") and b[0] > pcfg.prefix_threshold:
            return "prefix"
        if r.startswith("rgt") and \
                len(seqs[r]) - b[-1] > pcfg.prefix_threshold:
            return "suffix"
        return "internal"

    def stats(ids):
        truth = {r: world.boundary_bounds[r] for r in ids}
        mbp = sum(len(seqs[r]) for r in ids) / 1e6
        return {**bound_errors(bdec, truth), "mbp": mbp,
                **{name: sum(got.get(r) == name for r in ids)
                   for name in ("prefix", "internal", "suffix")}}

    ids = sorted(world.dec.records)
    pick = np.random.default_rng(WORLD_SEED).choice(
        len(ids), min(DECOMP_SAMPLE, len(ids)), replace=False)
    sample = [(ids[i], world.dec.records[ids[i]].seq) for i in sorted(pick)]
    t = time.perf_counter()
    sdec = decomposer.decompose(sample)
    sample_s = time.perf_counter() - t
    s_err = bound_errors(sdec, {r: world.dec.records[r].bounds
                                for r, _ in sample})
    s_mbp = sum(len(seq) for _, seq in sample) / 1e6
    b_mbp = sum(len(seq) for seq in seqs.values()) / 1e6
    emit({"phase": "decomposition", "library": os.path.relpath(lib, HERE),
          "build_seconds": build_s,
          "boundary": {"mbp": b_mbp, "seconds": boundary_s,
                       "mbp_per_s": b_mbp / boundary_s,
                       "shaped": stats(shaped),
                       "flank_crossing": {
                           **stats(crossing),
                           "class_as_flank": sum(got.get(r) == flank_class(r)
                                                 for r in crossing),
                           "by_flank": collections.Counter(
                               map(flank_class, crossing))}},
          "sample": {**s_err, "mbp": s_mbp, "seconds": sample_s,
                     "mbp_per_s": s_mbp / sample_s},
          "seconds": time.perf_counter() - t0})
    want = {r: "prefix" if r.startswith("pre") else "suffix" for r in shaped}
    check({r: got.get(r) for r in shaped} == want,
          f"shaped boundary reads: classify gave "
          f"{collections.Counter(got.get(r) for r in shaped)}")
    check(sum(got.get(r) == flank_class(r) for r in crossing)
          >= 0.95 * len(crossing), "flank-crossing reads: classify "
          "disagrees with their flanks")
    check(s_err["records"] >= 0.95 * len(sample)
          and s_err["true_unit_count"] >= 0.9 * len(sample),
          f"decomposed sample: {s_err}")
    return bdec


def bitmap_bits(words):
    """(..., W) uint32 bitmap words -> (..., 32 W) bool, bit v of word
    v // 32 at v."""
    words = np.ascontiguousarray(words, dtype="<u4")
    return np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)


def scoring_inputs(call):
    """The inputs of a recorded bulk-scoring call in both forms: (clouds
    (R, T, K) int32, contig pairs ck, cp, V, P) and (read bitmaps (R, T,
    W), contig bitmap (P, W)) as uint32 numpy."""
    if call["path"] == "matmul":
        clouds, ck, cp = call["clouds"], call["ck"], call["cp"]
        V, P = call["V"], call["P"]
        contig = np.zeros((P, max(1, -(-V // 32))), np.uint32)
        keep = cp < P
        np.bitwise_or.at(contig, (cp[keep], ck[keep] // 32),
                         (np.uint32(1) << (ck[keep] % 32).astype(np.uint32)
                          ).astype(np.uint32))
        return (clouds, ck, cp, V, P), (
            scoring.clouds_to_bitmaps(clouds, V), contig)
    reads, contig = call["reads"], call["contig"]
    bits = bitmap_bits(reads)
    V, P = bits.shape[-1], contig.shape[0]
    K = max(1, int(bits.sum(-1).max()))
    order = np.argsort(~bits, axis=-1, kind="stable")[..., :K]
    clouds = np.where(np.take_along_axis(bits, order, -1), order, -1)
    cp, ck = np.nonzero(bitmap_bits(contig))
    return (clouds.astype(np.int32), ck.astype(np.int32),
            cp.astype(np.int32), V, P), (reads, contig)


@contextlib.contextmanager
def recorded_scoring(calls):
    """Records every bulk-scoring call of the placement (either scorer):
    its inputs and outputs on the host and its milliseconds on the card
    (synchronised before and after)."""
    matmul, popcount = (scoring.placement_scores_matmul,
                        scoring.placement_scores)

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s0, s1 = fn(*args, **kw)
        torch.cuda.synchronize()
        return s0, s1, (time.perf_counter() - t) * 1e3

    def rec_matmul(clouds, ck, cp, n_kmers, n_pos):
        s0, s1, ms = timed(matmul, clouds, ck, cp, n_kmers=n_kmers,
                           n_pos=n_pos)
        calls.append({"path": "matmul", "clouds": clouds.cpu().numpy(),
                      "ck": ck.cpu().numpy(), "cp": cp.cpu().numpy(),
                      "V": n_kmers, "P": n_pos, "ms": ms,
                      "s0": s0.cpu().numpy(), "s1": s1.cpu().numpy()})
        return s0, s1

    def rec_popcount(reads, contig):
        s0, s1, ms = timed(popcount, reads, contig)
        calls.append({"path": "popcount",
                      "reads": reads.cpu().numpy().astype(np.uint32),
                      "contig": contig.cpu().numpy().astype(np.uint32),
                      "ms": ms, "s0": s0.cpu().numpy(),
                      "s1": s1.cpu().numpy()})
        return s0, s1

    scoring.placement_scores_matmul = rec_matmul
    scoring.placement_scores = rec_popcount
    try:
        yield
    finally:
        scoring.placement_scores_matmul = matmul
        scoring.placement_scores = popcount


def check_scoring_calls(calls, dev):
    """Every recorded call's scores against the other scorer on the card,
    on the same inputs; the first call's also against the port's CPU
    path of the scorer it took. Returns each call's (R, T, V, P)."""
    shapes = []
    for i, call in enumerate(calls):
        (clouds, ck, cp, V, P), (reads, contig) = scoring_inputs(call)
        mm = scoring.placement_scores_matmul(
            torch.from_numpy(clouds).to(dev), torch.from_numpy(ck).to(dev),
            torch.from_numpy(cp).to(dev), n_kmers=V, n_pos=P)
        pc = scoring.placement_scores(words_tensor(reads, dev),
                                      words_tensor(contig, dev))
        want = [call["s0"], call["s1"]]
        for got in (mm, pc):
            check(all(np.array_equal(g.cpu().numpy(), w)
                      for g, w in zip(got, want)),
                  f"scoring call {i}: matmul and popcount differ on the card")
        if i == 0:
            cpu = (scoring.placement_scores_matmul(
                torch.from_numpy(clouds), torch.from_numpy(ck),
                torch.from_numpy(cp), n_kmers=V, n_pos=P)
                if call["path"] == "matmul" else scoring.placement_scores(
                    words_tensor(reads, "cpu"), words_tensor(contig, "cpu")))
            check(all(np.array_equal(g.numpy(), w)
                      for g, w in zip(cpu, want)),
                  "scoring call 0: the card differs from the CPU")
        shapes.append([*clouds.shape[:2], V, P])
    return shapes


def phase_placement(world, dec, res, dev, outdir,
                    want_digest=PLACEMENT_DIGEST):
    """Stage 4 on the card at the full world: `run_placement` (the clouds
    of stage 3's unique k-mers, then the greedy placement, its bulk
    scoring on `dev`) and `run_placement_validation`, through the port's
    entry points. Every bulk-scoring call is recorded and held against
    the other scorer on the card, the first also against the CPU. Each
    read's placement is held against its first whole unit `u0` (the
    prefix reads seed position 0 at the array's first unit): placed,
    the offsets' histogram and the share at the modal offset, and the
    validation's agreement, with the phase's seconds and peak memory.
    The greedy stops where no read reaches a valid score, at a stretch
    of units without unique k-mers; the phase prints the contig's span,
    the unique k-mers by unit around its end, and the placeable records
    (the rule holds with every k-mer of their clouds matched) placed in
    all and inside the span. Fails unless read_positions.csv is the JAX
    package's for this world (`want_digest`, PLACEMENT_DIGEST for the
    full world; None skips it for other worlds), 95% of the placed reads
    sit at the modal offset 0, and 90% of them re-map to their
    placement. Both artifacts stay in `outdir`."""
    t0 = time.perf_counter()
    pcfg, kcfg = PlacerConfig(), KmerRecruitmentConfig()
    log = PhaseLog()
    calls = []
    torch.cuda.reset_peak_memory_stats()
    with recorded_scoring(calls), recording(log):
        t = time.perf_counter()
        placements, clouds = run_placement(dec, res.codes, pcfg, kcfg.k,
                                           outdir, device=dev)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t
    t = time.perf_counter()
    with recording(log):
        agree = run_placement_validation(placements, clouds, pcfg, kcfg,
                                         outdir)
    valid_s = time.perf_counter() - t
    pos_fn = os.path.join(outdir, "tr_resolution", "read_positions.csv")
    from_file = read_positions_file(pos_fn)
    digest = sha256_of(pos_fn)
    peak = torch.cuda.max_memory_allocated()
    sums = log.sums
    check(from_file == placements,
          "read_positions.csv differs from the placements")
    check(calls, "the placement made no bulk-scoring call")
    t = time.perf_counter()
    shapes = check_scoring_calls(calls, dev)
    check_s = time.perf_counter() - t
    placed = {r: p for r, p in placements.items() if p is not None}
    # placeable: the placement rule holds for the score a read would have
    # if every k-mer of its clouds matched (score1 = its k-mers, score0
    # = its non-empty clouds); with fewer, no offset can reach it
    placeable = [r for r, rc in clouds.items() if valid_score(
        pcfg, sum(len(c) > 0 for c in rc.clouds), sum(map(len, rc.clouds)))]
    # the greedy grows the contig from the prefix reads and stops where
    # no read reaches a valid score (a stretch of units without unique
    # k-mers, printed beside)
    span = max((p + clouds[r].n_units for r, p in placed.items()),
               default=0)
    inside = [r for r in placeable
              if world.u0[r] + clouds[r].n_units <= span]
    n_inside = sum(r in placed for r in inside)
    per_unit = unique_by_unit(world, res.codes, kcfg.k)
    offsets = collections.Counter(p - world.u0[r] for r, p in placed.items())
    modal, n_modal = offsets.most_common(1)[0] if offsets else (None, 0)
    n_agree = len(agree)
    seconds = {k: sums.get(k, 0.0) for k in (
        "placement_clouds", "placement_setup", "placement_scoring",
        "placement_greedy", "placement_artifact", "validation",
        "validation_artifact")}
    out = {"phase": "placement", "read_positions_sha256": digest,
           "equal_jax_placements": (None if want_digest is None
                                    else digest == want_digest),
           "records": len(dec.records),
           "unique_kmers": len(res.codes), "placed": len(placed),
           "placed_share": len(placed) / len(dec.records),
           "placeable": len(placeable),
           "placeable_placed": sum(r in placed for r in placeable),
           "contig_span_units": span, "placeable_in_span": len(inside),
           "placeable_in_span_placed": n_inside,
           "unique_once_by_unit_at_span_end": per_unit[
               max(0, span - 10):span + 30].tolist(),
           "offset_hist": dict(offsets.most_common(12)),
           "modal_offset": modal, "modal_share": n_modal / max(len(placed), 1),
           "validation_agree": n_agree,
           "agree_share": n_agree / max(len(placed), 1),
           "scoring": {"paths": sorted({c["path"] for c in calls}),
                       "calls": len(calls), "shapes_RTVP": shapes,
                       "ms": [c["ms"] for c in calls],
                       "equal_other_path_on_card": True,
                       "first_equal_cpu": True,
                       "check_seconds": check_s},
           "phase_seconds": seconds, "run_placement_seconds": place_s,
           "validation_seconds": valid_s, "max_memory_allocated": peak,
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(want_digest is None or digest == want_digest,
          "read_positions.csv differs from the JAX package's placements "
          "of this world")
    check(modal == 0 and n_modal >= 0.95 * len(placed),
          f"offset {modal} holds {n_modal} of {len(placed)} placed reads")
    check(n_agree >= 0.9 * len(placed),
          f"validation: {n_agree} of {len(placed)} placed reads agree")
    return out


KERNELS = {"k1": myers_hw_2strand, "k1c": myers_hw_chunks,
           "sf": fused_recruit.seed_filter_compact,
           "k2": myers_hw_v3, "k3": myers_hw_v3_banded, "k4": myers_perrow}
PIPELINE_STAGES = ("run_recruitment", "run_decomposition",
                   "run_unique_kmers", "run_placement",
                   "run_placement_validation", "run_unit_consensus",
                   "run_polisher", "run_tandem_polish")


def timed_pipeline(pipe, seconds, calls):
    """Wrap each stage method of `pipe` (the port's or the JAX package's)
    to add its seconds (synchronised with the card) to `seconds` and keep
    its arguments in `calls`."""
    on_card = getattr(pipe, "device", torch.device("cpu")).type == "cuda"

    def wrap(name, fn):
        def stage(*args):
            t = time.perf_counter()
            out = fn(*args)
            if on_card:
                torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            calls[name] = args
            return out
        return stage
    for name in PIPELINE_STAGES:
        setattr(pipe, name, wrap(name, getattr(pipe, name)))
    return pipe


def report_distances(fn):
    """The editDistance of each line of a polish report.txt, in order."""
    with open(fn) as f:
        return [ast.literal_eval(ln)["editDistance"] for ln in f
                if ln.startswith("{")]


def write_pipeline_reads(fn, world, background):
    """The cenX pipeline's reads file: the world's records (ids w*), its
    reads over the array's ends with their full sequences, and the
    background reads. Returns the ids of the first two groups and the
    file's Mbp."""
    reads = {r: rec.seq for r, rec in sorted(world.dec.records.items())}
    reads.update(world.boundary)
    cen = set(reads)
    reads.update(background)
    write_seqs(fn, reads)
    return cen, sum(map(len, reads.values())) / 1e6


@contextlib.contextmanager
def captured_fused_k1():
    """Keeps every FUSED_EVERY-th fused recruitment step's survivor
    scoring, K1c's call (its arguments: tensors the step made, kept by
    reference, among them the distances K1c wrote into the step's
    bundle), in the list it yields, for `hold_fused_k1` after the run."""
    captured, steps, score = [], [0], fused_recruit.myers_hw_chunks

    def capture(*args, m, C=None):
        score(*args, m=m, C=C)
        if steps[0] % FUSED_EVERY == 0:
            captured.append(args)
        steps[0] += 1
    fused_recruit.myers_hw_chunks = capture
    try:
        yield captured
    finally:
        fused_recruit.myers_hw_chunks = score


def plain_both_strands(peq_f, peq_r, text_t, lens, *, m):
    """`myers_hw_2strand_plain`'s outputs from one plain call: the two
    strands as 2B rows with per-row queries, so one column loop scores
    both (the plain version is launch-bound at these row counts)."""
    B, W = text_t.shape[1], peq_f.shape[1]
    text = text_t.t()
    out = myers_distance_batch(
        torch.cat([peq_f.expand(B, 5, W), peq_r.expand(B, 5, W)]),
        torch.cat([text, text]), torch.cat([lens, lens]).reshape(-1), m=m,
        mode="HW")
    return {"dist_f": out["dist"][:B], "end_f": out["end"][:B],
            "dist_r": out["dist"][B:], "end_r": out["end"][B:]}


def scored_rows(args) -> torch.Tensor:
    """The rows a captured K1c call scored: top[:min(n_pass, K)]."""
    top, n_pass = args[5], args[6]
    return top[:min(int(n_pass[0]), top.numel())]


def hold_fused_k1(captured, m, rate, threshold, path):
    """K1c against the plain version on whole rows, on every row one fused
    step of `path`'s recruitment scored, at its segment length
    (PIPELINE_SEG_LEN columns): the distances K1c wrote into the step's
    bundle equal `plain_both_strands` on the rows unpacked. Of the
    `captured` calls, the one is taken with a full-length scored row and
    scored rows both within and past `threshold`, if there is one, and
    of those the one with most rows within. Then K1c's launch again and
    K1 on the same rows whole are timed. Returns the fields for the
    phase's line and K1c's instance."""
    scored = []
    for args in captured:
        rows = scored_rows(args)
        if not rows.numel():
            continue
        dist_f, dist_r = args[7][rows], args[8][rows]
        d = torch.minimum(dist_f, dist_r)
        scored.append(((int(args[4][rows].max()) == PIPELINE_SEG_LEN,
                        int((d <= threshold).sum()) > 0
                        and int((d > threshold).sum()) > 0,
                        int((d <= threshold).sum())), args, rows))
    check(scored, f"{path}'s recruitment scored no row in a fused step")
    key, args, rows = max(scored, key=lambda x: x[0])
    check(key[0], f"no captured fused step of {path} scored a "
          f"{PIPELINE_SEG_LEN}-column row")
    words_f, words_r, packed, n_mask, lens, top, n_pass, dist_f, dist_r = args
    peq_f, peq_r = (w.long() & MASK for w in (words_f, words_r))
    codes = (fused_recruit._unpack_nomask(packed[rows]) if n_mask is None
             else fused_recruit._unpack_2bit(packed[rows], n_mask[rows]))
    text_t = codes.t().contiguous()
    want, plain_ms = timed_plain(
        lambda: plain_both_strands(peq_f, peq_r, text_t, lens[rows], m=m))
    got = {"dist_f": dist_f[rows], "dist_r": dist_r[rows]}
    err = max_abs_err(got, want)
    again = [torch.full_like(dist_f, m) for _ in range(2)]
    ms = time_cuda(lambda: myers_hw_chunks(*args[:7], *again, m=m), reps=5)
    err = max(err, max_abs_err({"dist_f": again[0][rows],
                                "dist_r": again[1][rows]}, want))
    k1_ms = time_cuda(lambda: myers_hw_2strand(peq_f, peq_r, text_t,
                                               lens[rows], m=m), reps=5)
    n = rows.numel()
    bound_ms, _ = myers_bound(lens[rows], peq_f.shape[1], 2, rate)
    check(err == 0, f"K1c != plain on {path}'s fused step "
          f"({n} of {packed.shape[0]} rows x {PIPELINE_SEG_LEN}, m = {m})")
    fields = {"m": m, "rows": n, "candidate_rows": packed.shape[0],
              "sum_lens": int(lens[rows].sum()), "rows_in_band": key[2],
              "mixed_band": key[1], "max_abs_err": err, "ms": ms,
              "k1_whole_rows_ms": k1_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "chunk_columns": chunk_columns(
                  m, PIPELINE_SEG_LEN, n, chunk_blocks(packed.device)),
              "batches_captured": len(captured)}
    return fields, {f"{n}x{PIPELINE_SEG_LEN} {path} fused step": fields}


def phase_cenx_pipeline(unit, world, background, dev, outdir, rate,
                        want=(ASSEMBLY_DIGEST, UNIT_STAR_DIGEST)):
    """The cenX pipeline from a reads file to final_assembly.fasta on the
    card, at the full world: `CenXPipeline(unit, CentroFlyeConfig(),
    outdir, device=dev).run(reads)`. Stage 1 recruits from the world's
    records, its reads over the array's ends and `background` (K1c in
    the fused step); stages 2-4 resume from the artifacts that phases
    unique_kmers and placement left in `outdir` (decomposition.json,
    the unique k-mers, read_positions.csv, placement_validation.csv);
    stages 5 and 6 run. Fails unless K1c launched, the recruited reads
    are every world read and no background read, equal to the exact
    tier's set (prefilter off) on the same file, K1c on one of its fused
    steps equals the plain version (`hold_fused_k1`, at the pipeline's
    segment length), unit* is within 5 edits
    (NW) of the unit, and the assembly, held against the simulated array
    over the polished units min_p..max_p at offset 0 (NW), diverges by
    at most 0.5% with a length within 1% of that span; and unless
    final_assembly.fasta and unit_star.fasta have the sha256 in `want`
    (the JAX package's files for this world, tools/cenx_vs_jax.py;
    None skips one). Prints each stage's seconds, the polished
    positions, the assembly's length and divergence, the edit distances
    between the iterations of both polish reports and the peak device
    memory. Returns the kernels' launches and K1c's instance on this
    path."""
    t0 = time.perf_counter()
    reads_fn = os.path.join(outdir, "reads.fasta")
    cen, mbp = write_pipeline_reads(reads_fn, world, background)
    write_s = time.perf_counter() - t0
    cfg = CentroFlyeConfig()
    seconds, calls = {}, {}
    pipe = timed_pipeline(CenXPipeline(unit, cfg, outdir, device=dev),
                          seconds, calls)
    for kernel in KERNELS.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with captured_fused_k1() as captured:
        final = pipe.run(reads_fn)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {k: kernel.launches for k, kernel in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    fused, k1_instance = hold_fused_k1(captured, len(unit), rate, THRESHOLD,
                                       "cenx_pipeline")
    fused["seconds"] = time.perf_counter() - t
    del captured
    check(launches["k1c"] > 0, "the cenX pipeline's fused step launched K1c "
          "no time")
    check(launches["sf"] == launches["k1c"], f"the seed filter kernel "
          f"launched {launches['sf']} times in {launches['k1c']} fused steps "
          f"of the cenX pipeline")
    check(set(seconds) == set(PIPELINE_STAGES),
          f"stages run: {sorted(seconds)}")

    recruited = [r for r, _ in iter_seqs(os.path.join(
        outdir, "centromeric_reads.fasta"))]
    t = time.perf_counter()
    exact = RecruitmentEngine(unit, RecruitmentConfig(prefilter=False),
                              device=dev)
    exact_set = {r.r_id for r in exact.run(iter_seqs(reads_fn))
                 if r.recruited}
    exact_s = time.perf_counter() - t
    check(set(recruited) == cen,
          f"recruited: {len(cen - set(recruited))} world reads missed, "
          f"{len(set(recruited) - cen)} background reads taken")
    check(set(recruited) == exact_set,
          f"recruited != the exact tier's set: "
          f"{sorted(set(recruited) ^ exact_set)[:10]}")

    star_fn = os.path.join(outdir, "cons_unit", "unit_star.fasta")
    final_fn = os.path.join(outdir, "final_assembly.fasta")
    unit_star = read_seq(star_fn)
    star_edits = _edit_distance(unit_star, unit)
    dec, placements_p = calls["run_polisher"]
    pcfg = cfg.polisher
    positions = sorted(map_pos2read(
        placements_p, {r: rec.motif_alignments()
                       for r, rec in dec.records.items()},
        min_pos=pcfg.min_pos, max_pos=pcfg.max_pos))
    min_p, max_p = positions[0], positions[-1]
    m = world.unit_len
    truth = decode(world.arr[min_p * m:(max_p + 1) * m])
    t = time.perf_counter()
    edits = _edit_distance(final, truth)
    edit_s = time.perf_counter() - t
    with open(os.path.join(outdir, "metrics.json")) as f:
        metrics = {k: v["wall_s"] for k, v in json.load(f).items()}
    digests = {"final_assembly": sha256_of(final_fn),
               "unit_star": sha256_of(star_fn)}
    out = {"phase": "cenx_pipeline", "reads_mbp": mbp,
           "world_reads": len(cen), "background_reads": len(background),
           "recruited": len(recruited), "exact_tier_equal": True,
           "exact_tier_seconds": exact_s, "launches": launches,
           "k1_fused_step_vs_plain": fused,
           "unit_star_len": len(unit_star), "unit_star_edits": star_edits,
           "polished_positions": len(positions), "min_p": min_p,
           "max_p": max_p, "assembly_len": len(final),
           "span_len": len(truth), "assembly_edits": edits,
           "divergence": edits / len(truth), "edit_seconds": edit_s,
           "polishing_report": report_distances(
               os.path.join(outdir, "polishing", "report.txt")),
           "tandem_polish_report": report_distances(
               os.path.join(outdir, "polishing2", "report.txt")),
           "stage_seconds": seconds, "metrics_wall_s": metrics,
           "run_seconds": run_s, "write_reads_seconds": write_s,
           "max_memory_allocated": peak, "sha256": digests,
           "equal_jax": {k: None if w is None else digests[k] == w
                         for k, w in zip(digests, want)},
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(star_edits <= 5, f"unit* is {star_edits} edits from the unit")
    check(edits <= 0.005 * len(truth),
          f"assembly: {edits} edits over a {len(truth)}-bp span")
    check(abs(len(final) - len(truth)) <= 0.01 * len(truth),
          f"assembly length {len(final)} against a {len(truth)}-bp span")
    for (name, got), w in zip(digests.items(), want):
        check(w is None or got == w,
              f"{name} differs from the JAX package's file for this world")
    return launches, k1_instance, out


def phase_cenx_fresh(dev):
    """The cenX pipeline with nothing resumed, at tests/test_e2e_cenx.py's
    world and config (`fresh_world`, `fresh_config`): from one reads
    file, on the card and on the CPU. Every artifact but metrics.json
    must be equal, and a second run on the card must resume from them
    and return the same assembly."""
    t0 = time.perf_counter()
    unit, _, reads = fresh_world()
    with tempfile.TemporaryDirectory() as tmp:
        reads_fn = os.path.join(tmp, "reads.fasta")
        write_seqs(reads_fn, reads)
        finals, files, seconds = {}, {}, {}
        for where, d in (("card", dev), ("cpu", "cpu"), ("resume", dev)):
            out = os.path.join(tmp, "card" if where == "resume" else where)
            stage_s = {}
            pipe = timed_pipeline(CenXPipeline(unit, fresh_config(), out,
                                               device=d), stage_s, {})
            myers_hw_2strand.launches = 0
            myers_hw_chunks.launches = 0
            finals[where] = pipe.run(reads_fn)
            seconds[where] = {**stage_s,
                              "k1_launches": myers_hw_2strand.launches,
                              "k1c_launches": myers_hw_chunks.launches}
            files[where] = file_digests(out)
    same = files["card"] == files["cpu"]
    emit({"phase": "cenx_fresh", "reads": len(reads),
          "artifacts": len(files["card"]), "identical": same,
          "assembly_len": len(finals["card"]),
          "resume_equal": finals["resume"] == finals["card"],
          "stage_seconds": seconds, "seconds": time.perf_counter() - t0})
    check(seconds["card"]["k1_launches"] + seconds["card"]["k1c_launches"]
          > 0, "cenx_fresh: the card's run launched K1 and K1c no time")
    check(len(files["card"]) == 17 and same,
          f"cenx_fresh: the card's artifacts differ from the CPU's: "
          f"{sorted(k for k in files['card'] if files['card'][k] != files['cpu'].get(k))}")
    check(finals["card"] == finals["cpu"] == finals["resume"]
          and files["resume"] == files["card"],
          "cenx_fresh: the resumed run differs")
    return files["card"]


def k4_rows(rng, monomers, R, Wlen, dev):
    """One lockstep step of the monomer decomposer at cen6's shape: R
    windows of Wlen columns cut from noisy tandem copies of the D6Z1 HOR
    (the monomers joined), on both strands, with ragged lengths, a
    zero-length window, an all-N window (its best is the empty
    alignment), an N run, a random window and windows of 1 and 10
    columns."""
    hor = encode("".join(monomers.values()))
    src = [add_noise(rng, np.tile(hor, 4), CEN6_NOISE)[0],
           revcomp(add_noise(rng, np.tile(hor, 4), CEN6_NOISE)[0])]
    windows = np.empty((R, Wlen), np.int8)
    for r in range(R):
        s = src[r % 2]
        a = int(rng.integers(0, s.size - Wlen))
        windows[r] = s[a:a + Wlen]
    wlens = np.full(R, Wlen, np.int32)
    wlens[R // 2:] = rng.integers(1, Wlen + 1, R - R // 2)
    wlens[5] = 0
    windows[6] = 4
    windows[7, 80:120] = 4
    windows[8] = rng.integers(0, 4, Wlen)
    wlens[9], wlens[10] = 1, 10
    return (torch.from_numpy(windows).to(dev), torch.from_numpy(wlens).to(dev))


def perrow_bound(wlens, L, Q, words, rate, collect="call"):
    """(bound_ms, bound_by) of one K4 call: every window's first
    min(wlens, L) columns against Q queries of `words` words
    (OPS_PER_WORD_COLUMN each), against the bytes read once (windows,
    lengths, peq tables and query lengths) and written once (each
    window's call, 12 bytes, or with collect="all" every row's L
    scores)."""
    n = int(wlens.clamp(0, L).sum())
    ops = OPS_PER_WORD_COLUMN * words * n * Q
    R = wlens.numel()
    out_bytes = 12 * R if collect == "call" else 4 * R * Q * L
    nbytes = R * L + 4 * R + Q * (5 * 4 * words + 4) + out_bytes
    op_ms, byte_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def k4_small(rng, m, dev, Q=5, R=7, L=None):
    """Q queries of lengths in [1, m] (m among them) and R windows of L
    columns (m + 40 by default; ragged, one of length 0, one holding a
    query's copy), as the decomposer lays them out: -> (queries,
    windows, wlens) on `dev`."""
    L = m + 40 if L is None else L
    qlens = np.concatenate([[m], rng.integers(1, m + 1, Q - 1)])
    queries = [rng.integers(0, 4, int(n)).astype(np.int8) for n in qlens]
    peqs = np.stack([build_peq(q, m=m) for q in queries])
    windows = rng.integers(0, 5, (R, L)).astype(np.int8)
    windows[0, 10:10 + m] = queries[0]
    wlens = rng.integers(0, L + 1, R).astype(np.int32)
    wlens[0], wlens[1] = L, 0
    return (perrow_queries(words_tensor(peqs, dev), qlens.astype(np.int32),
                           m=m, device=dev),
            torch.from_numpy(windows).to(dev), torch.from_numpy(wlens).to(dev))


def mutate(rng, codes, n, lo, hi):
    """codes with n substitutions at distinct, spread positions in
    [lo, hi), each to another base."""
    out = codes.copy()
    at = lo + (np.arange(n) * (hi - lo)) // n + rng.integers(0, 3, n)
    out[at] = (out[at] + rng.integers(1, 4, n)) % 4
    return out


def k4_ties(rng, dev):
    """Windows whose calls tie exactly in dist / m: query 0 is a random
    170-mer A, query 1 its first 85 bases, then a random 170-mer and a
    random 85-mer. Windows of 234 columns hold A with 10 substitutions, 5
    of them in its first 85 bases (10/170 = 5/85: query 0 wins by being
    first), 4 of them (query 1 wins), 6 of them (query 0 wins), the same
    with fewer substitutions (2 and 1), A unchanged (0/170 = 0/85), and
    all-N and zero-length windows (every query m/m). -> (queries,
    windows, wlens) on `dev`."""
    A = rng.integers(0, 4, 170).astype(np.int8)
    qs = [A, A[:85], rng.integers(0, 4, 170).astype(np.int8),
          rng.integers(0, 4, 85).astype(np.int8)]
    L = 234
    rows = []
    for total, first in ((10, 5), (10, 4), (10, 6), (2, 1), (0, 0)):
        for _ in range(4):
            rows.append(np.concatenate([
                mutate(rng, A[:85], first, 2, 83),
                mutate(rng, A[85:], total - first, 2, 83),
                rng.integers(0, 4, L - 170).astype(np.int8)]))
    windows = np.stack(rows + [np.full(L, 4, np.int8)] * 2
                       + [rng.integers(0, 4, L).astype(np.int8)] * 2)
    wlens = np.full(len(windows), L, np.int32)
    wlens[-2:] = 0
    peqs = np.stack([build_peq(q, m=170) for q in qs])
    return (perrow_queries(words_tensor(peqs, dev),
                           np.array([len(q) for q in qs], np.int32),
                           m=170, device=dev),
            torch.from_numpy(windows).to(dev), torch.from_numpy(wlens).to(dev))


def exact_ties(dist, ms):
    """Windows whose least dist / m two or more queries reach: dist (R,
    Q), ms (Q,) integer tensors (cross-multiplied, exact)."""
    d, m = dist.long(), ms.long()
    best = torch.argmin(d.double() / m.double(), dim=1)
    bd, bm = d.gather(1, best[:, None]), m[best][:, None]
    return int(((d * bm == bd * m).sum(1) > 1).sum())


def k4_to_cpu(args):
    """K4's arguments (queries, windows, wlens) moved to the CPU."""
    queries, windows, wlens = args
    return (perrow_queries(queries.peqs.cpu(), queries.ms.cpu(),
                           m=queries.m, device="cpu"),
            windows.cpu(), wlens.cpu())


def k4_tiled(rng, m, dev):
    """`k4_small` at shapes whose columns K4 stages in several tiles: 2
    queries against 1,000 windows of 2,100 columns (on 132 SMs, 8
    windows a block and tiles of 16 KB / 8 = 2,048 columns), and at
    m > 224 also 256 queries against 3 windows of 5,000 columns (one
    window a block, whose tables leave tiles of 4,080 columns of the
    block's 48 KB)."""
    cases = [k4_small(rng, m, dev, Q=2, R=1000, L=2100)]
    if m > 224:
        cases.append(k4_small(rng, m, dev, Q=256, R=3, L=5000))
    return cases


def k4_against_plain(args, cpu=True):
    """max_abs_err of K4 (both calls) against the plain version on the
    same arguments, on the CPU or (cpu=False) on the card."""
    plain_args = k4_to_cpu(args) if cpu else args
    return max(max_abs_err(
        myers_perrow(*args, mode=mode, collect=collect),
        myers_perrow_plain(*plain_args, mode=mode, collect=collect))
        for mode, collect in PERROW_CALLS)


def phase_k4(dev, rate):
    """K4 (`myers_perrow`) against its plain version on the card at two
    steps of the monomer decomposer: the real 18 D6Z1 monomers on both
    strands (36 queries, m = 173, W = 6) against K4_WINDOWS windows of
    the decomposer's width, 32 (1,152 rows, the JAX package's batch) and
    1,024 (36,864 rows, a full batch), in both of the
    decomposer's calls (SHW/call, every later step; HW/all, the first
    step); then m in K4_SMALL_M and the tie set (`k4_ties`) against the
    plain version on the CPU, and the shapes K4 stages in several tiles
    (`k4_tiled`) against the plain version on the card. max_abs_err must
    be 0; the all-N window must give query 0's empty alignment. Prints,
    for each shape and call, K4's device ms (launches queued ahead of
    the device, `time_cuda`), its bound and share; the plain version's
    ms and the wrapper's host microseconds a call."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    monomers = read_seqs(D6Z1_MONOMERS)
    dec = MonomerDecomposer(monomers, device=dev)
    Q, Wlen, words = dec.ms.size, dec.window, dec.peqs.shape[2]
    err, instances = 0, {}
    for R in K4_WINDOWS:
        windows, wlens = k4_rows(rng, monomers, R, Wlen, dev)
        args = (dec.queries, windows, wlens)
        for mode, collect in PERROW_CALLS:
            call = f"{mode}/{collect}"
            want, plain_ms = timed_plain(
                lambda: myers_perrow_plain(*args, mode=mode, collect=collect))
            bound_ms, bound_by = perrow_bound(wlens, Wlen, Q, words, rate,
                                              collect)
            row = {"windows": R, "rows": R * Q, "cols": Wlen,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            got = myers_perrow(*args, mode=mode, collect=collect)
            err = max(err, max_abs_err(got, want))
            if collect == "call":
                check(int(got["q"][6]) == 0 and int(got["end"][6]) == -1
                      and int(got["dist"][6]) == int(dec.ms[0]),
                      "an all-N window must call query 0 at its empty "
                      "alignment (m, -1)")
            row["ms"] = time_cuda(lambda: myers_perrow(
                *args, mode=mode, collect=collect),
                reps=K4_REPS, must_queue=True)
            row["share"] = bound_ms / row["ms"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(K4_REPS):
                myers_perrow(*args, mode=mode, collect=collect)
            row["host_us_per_call"] = ((time.perf_counter() - t) / K4_REPS
                                       * 1e6)
            torch.cuda.synchronize()
            instances[f"{R * Q}x{Wlen} {call}"] = row
    check(err == 0, f"K4 != plain at {K4_WINDOWS} windows x {Q} queries")
    small_err = {sm: k4_against_plain(k4_small(rng, sm, dev))
                 for sm in K4_SMALL_M}
    check(max(small_err.values()) == 0,
          f"K4 != the CPU plain version: {small_err}")
    tiled_err = {sm: max(k4_against_plain(args, cpu=False)
                         for args in k4_tiled(rng, sm, dev))
                 for sm in K4_SMALL_M}
    check(max(tiled_err.values()) == 0,
          f"K4 != plain where it stages several tiles: {tiled_err}")
    ties = k4_ties(rng, dev)
    tie_err = k4_against_plain(ties)
    best = myers_perrow_plain(*k4_to_cpu(ties), mode="SHW", collect="best")
    n_ties = exact_ties(best["dist"].reshape(len(ties[1]), -1),
                        ties[0].ms.cpu())
    check(tie_err == 0, f"K4 != the CPU plain version on the tie set: "
          f"{tie_err}")
    check(n_ties >= 8, f"the tie set holds {n_ties} exact ties")
    emit({"phase": "k4", "m": dec.max_m, "words": words, "queries": Q,
          "max_abs_err": err, "instances": instances,
          "small_max_abs_err": small_err, "tiled_max_abs_err": tiled_err,
          "tie_windows": n_ties, "tie_max_abs_err": tie_err,
          "seconds": time.perf_counter() - t0})
    main = instances[f"{K4_WINDOWS[0] * Q}x{Wlen} SHW/call"]
    return {"max_abs_err": max(err, tie_err, *small_err.values(),
                               *tiled_err.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "instances": instances}


def build_symbol_genome(rng, n_hor, n_mono, variant_every=CEN6_VARIANT_EVERY):
    """benchmarks/bench_mono_cen6.build_symbol_genome: n_hor copies of the
    n_mono-monomer HOR with a monomer substituted at one in
    `variant_every` positions, which makes the k-sweep's k-mers
    position-unique."""
    syms = np.tile(np.arange(n_mono, dtype=np.int16), n_hor)
    n_var = len(syms) // variant_every
    marks = rng.choice(len(syms), size=n_var, replace=False)
    for pos in marks:
        cur = int(syms[pos])
        alt = [x for x in range(n_mono) if x != cur]
        syms[pos] = alt[int(rng.integers(0, n_mono - 1))]
    return syms


def cen6_length_mix(rng, n):
    """benchmarks/bench_mono_cen6.read_length_mix: rel3's ultra-long mix
    in monomers (30% around 700, the rest around 280, 30-2,000)."""
    ul = rng.random(n) < 0.3
    lens = np.where(ul, rng.lognormal(np.log(700), 0.5, n),
                    rng.lognormal(np.log(280), 0.55, n))
    return np.clip(lens, 30, 2000).astype(np.int64)


@dataclasses.dataclass
class Cen6World:
    """The simulated cen6 world of `cen6_world`."""

    monomers: dict            # D6Z1's monomers, name -> sequence
    syms: np.ndarray          # the array in monomer symbols
    arr: np.ndarray           # its codes
    bounds: np.ndarray        # where each monomer starts in arr, then its end
    reads: list               # (r_id, seq)
    # a '+' read -> (where its source starts in arr, `add_noise`'s cum)
    truth: dict


def cen6_world(seed=CEN6_SEED, n_hor=CEN6_HORS, coverage=CEN6_COVERAGE):
    """The cen6 array of benchmarks/bench_mono_cen6.py in nucleotides:
    `build_symbol_genome` over the real D6Z1 monomers, each symbol its
    monomer's sequence. Reads of `cen6_length_mix` at `coverage` over it
    (starting inside a monomer, ending inside one), CEN6_NOISE of
    `add_noise`, strands half and half."""
    monomers = read_seqs(D6Z1_MONOMERS)
    codes = [encode(s) for s in monomers.values()]
    rng = np.random.default_rng(seed)
    syms = build_symbol_genome(rng, n_hor, len(codes))
    mlen = np.array([len(c) for c in codes])[syms]
    bounds = np.concatenate([[0], np.cumsum(mlen)])
    arr = np.concatenate([codes[s] for s in syms])
    L = len(syms)
    n_reads = int(coverage * L / CEN6_MEAN_MONOMERS)
    lens = cen6_length_mix(rng, n_reads)
    starts = rng.integers(-50, L - 20, size=n_reads)
    reads, truth = [], {}
    for i in range(n_reads):
        s = max(0, int(starts[i]))
        e = min(L, s + int(lens[i]))
        if e - s < 30:
            continue
        a = int(bounds[s] + rng.integers(0, mlen[s]))
        b = int(bounds[e - 1] + rng.integers(1, mlen[e - 1] + 1))
        noisy, cum = add_noise(rng, arr[a:b], CEN6_NOISE)
        r_id = f"c{i:05d}"
        if rng.random() < 0.5:
            reads.append((r_id, decode(noisy)))
            truth[r_id] = (a, cum)
        else:
            reads.append((r_id, decode(revcomp(noisy))))
    return Cen6World(monomers, syms, arr, bounds, reads, truth)


def call_accuracy(world, sd):
    """bench_mono_cen6.part_a_decomposition's indel-robust measure on the
    '+' reads: each call's own nucleotide span, its midpoint carried to
    the array through the noise (`cum`), names the monomer it must be.
    -> (calls, correct, '+' reads whose monostring was flipped)."""
    n = len(world.monomers)
    calls = correct = flipped = 0
    for r_id, (a, cum) in world.truth.items():
        ms = sd.monostrings.get(r_id)
        if ms is None:
            continue
        if ms.strand != "+":
            flipped += 1
            continue
        ok = (ms.syms != GAP) & (ms.nucl[:, 0] >= 0)
        mid = (ms.nucl[ok, 0] + ms.nucl[ok, 1]) // 2
        src = np.searchsorted(cum, mid, side="right") - 1
        t = np.searchsorted(world.bounds, a + src, side="right") - 1
        calls += int(ok.sum())
        correct += int((ms.syms[ok] % n == world.syms[t] % n).sum())
    return calls, correct, flipped


def find_run(hay, needle):
    """Where the int16 run `needle` starts in `hay`, or -1."""
    hb, nb = hay.astype(np.int16).tobytes(), needle.astype(np.int16).tobytes()
    p = hb.find(nb)
    while p >= 0 and p % 2:
        p = hb.find(nb, p + 1)
    return p // 2 if p >= 0 else -1


def tree_digest(root):
    """sha256 over the sorted (relative path, sha256) of every file."""
    h = hashlib.sha256()
    for r, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            fn = os.path.join(r, name)
            h.update(f"{os.path.relpath(fn, root)} {sha256_of(fn)}\n"
                     .encode())
    return h.hexdigest()


MONO_STAGES = ("error_correction", "iterative_graph", "scaffolding",
               "polish_scaffolds")


@contextlib.contextmanager
def timed_mono(pipeline_module, consensus_module, seconds, calls, polished):
    """While open, each of MONO_STAGES that `pipeline_module`
    (mono/pipeline.py of the port or of the JAX package) calls adds its
    seconds to `seconds` and keeps its arguments in `calls`, and every
    `polish_consensus` of `consensus_module` appends its result to
    `polished`."""
    saved = {name: getattr(pipeline_module, name) for name in MONO_STAGES}
    polish = consensus_module.polish_consensus

    def wrap(name, fn):
        def stage(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            calls[name] = args
            return out
        return stage

    def polish_one(*args, **kwargs):
        out = polish(*args, **kwargs)
        polished.append(out)
        return out
    for name, fn in saved.items():
        setattr(pipeline_module, name, wrap(name, fn))
    consensus_module.polish_consensus = polish_one
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(pipeline_module, name, fn)
        consensus_module.polish_consensus = polish


def pseudounit_divergence(world, polish_args, polished, n_iter):
    """Each polished pseudounit against the array's nucleotides of the
    same monomers (NW, native): the scaffolds' places in the array, and
    per pseudounit its edits and length. `polish_args` are
    polish_scaffolds' (scaffolds, pseudounits, read_pseudounits, ...),
    `polished` its polish_consensus results in call order."""
    scaffolds, pseudounits, read_pseudounits = polish_args[:3]
    at = [find_run(world.syms, s) for s in scaffolds]
    units, it = [], iter(polished)
    for i, scaf_units in enumerate(pseudounits):
        for j, (s_st, s_en) in enumerate(scaf_units):
            if j >= len(read_pseudounits[i]) or not read_pseudounits[i][j]:
                continue
            seq = next(it)[n_iter]
            if at[i] < 0:
                continue
            truth = decode(world.arr[world.bounds[at[i] + s_st]:
                                     world.bounds[at[i] + s_en + 1]])
            units.append((_edit_distance(seq, truth), len(truth)))
    check(next(it, None) is None, "unmatched polish_consensus calls")
    return at, units


def phase_cen6_pipeline(world, background, dev, outdir, rate,
                        want=(CEN6_SCAFFOLD_DIGEST, CEN6_IDB_DIGEST)):
    """The cen6 path on the card at cen6's array size (`cen6_world`):
    `recruit_file` with the D6Z1 unit at CEN6_THRESHOLD on a reads file
    of the world's reads and `background` (K1c in the fused step), then
    `MonoPipeline(MonoConfig(), outdir, device=dev)`: `decompose` on the
    recruited reads (K4, one launch a lockstep step) and `run` (error
    correction, the k = 100..400 de Bruijn sweep, scaffolding and the
    automatic join, pseudounit polishing). Fails unless K1c and K4
    launched, the recruited set is the world's reads and equals the
    exact tier's (prefilter off), the call accuracy on '+' reads is at
    least CEN6_MIN_ACCURACY, every scaffold is an exact run of the
    array's symbols, the polished pseudounits are within
    CEN6_MAX_DIVERGENCE of the array over the same monomers, and the
    sha256 of polishing/scaffold_0/scaffold_0.fasta and of idb/ (every
    file, `tree_digest`) are those in `want` (the JAX package's files
    for this world, tools/cen6_vs_jax.py; None skips one). Prints each
    stage's seconds, the decomposition's rate, steps and K4's device
    time on a sample of steps, and the peak device memory. K1c on one of
    recruitment's fused steps must equal the plain version
    (`hold_fused_k1`, m = 3222). Returns the launches, K1c's instance, the
    SDReport and the phase's line. Recruitment and the decomposition run
    under a recording of the port's spans and counters, and the line
    gives each `engine.` and `decomposer.` span's self seconds and each
    counter; the decomposer's steps must equal K4's launches."""
    t0 = time.perf_counter()
    program = Recording()
    reads_fn = os.path.join(outdir, "reads.fasta")
    cen_fn = os.path.join(outdir, "cen_reads.fasta")
    seqs = dict(world.reads)
    seqs.update(background)
    write_seqs(reads_fn, seqs)
    mbp = sum(map(len, seqs.values())) / 1e6
    del seqs
    world_ids = {r for r, _ in world.reads}
    for kernel in KERNELS.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    t = time.perf_counter()
    with captured_fused_k1() as captured, recording(program):
        n_rec = recruit_file(D6Z1_FASTA, reads_fn, cen_fn, CEN6_THRESHOLD,
                             device=dev)
    torch.cuda.synchronize()
    seconds["recruitment"] = time.perf_counter() - t
    k1_launches = {k: KERNELS[k].launches for k in ("k1", "k1c", "sf")}
    t = time.perf_counter()
    fused, k1_instance = hold_fused_k1(captured, len(read_seq(D6Z1_FASTA)),
                                       rate, CEN6_THRESHOLD, "cen6_pipeline")
    fused["seconds"] = time.perf_counter() - t
    del captured
    recruited = list(iter_seqs(cen_fn))
    t = time.perf_counter()
    exact = RecruitmentEngine(read_seq(D6Z1_FASTA), RecruitmentConfig(
        threshold=CEN6_THRESHOLD, prefilter=False), device=dev)
    exact_set = {r.r_id for r in exact.run(iter_seqs(reads_fn))
                 if r.recruited}
    exact_s = time.perf_counter() - t
    rec_ids = {r for r, _ in recruited}

    pipe = MonoPipeline(MonoConfig(), outdir, device=dev)
    # every K4_SAMPLE_EVERY-th step's K4 launch, queued behind a spin so
    # that its events time the device's work alone; each launch's windows
    # and call. A sample the host did not queue ahead of the device grows
    # the spin fourfold for the later ones, up to K4_SPIN_MAX times.
    events, queued, calls, steps = [], [], [0], []
    spin = [SPIN_CYCLES]
    perrow = parallel_mesh.myers_perrow

    def timed_perrow(queries, windows, *args, **kwargs):
        calls[0] += 1
        steps.append((windows.shape[0], kwargs.get("collect")))
        if calls[0] % K4_SAMPLE_EVERY:
            return perrow(queries, windows, *args, **kwargs)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin[0])
        e0.record()
        out = perrow(queries, windows, *args, **kwargs)
        queued.append(not e0.query())
        e1.record()
        events.append((e0, e1))
        if not queued[-1]:
            spin[0] = min(4 * spin[0], K4_SPIN_MAX * SPIN_CYCLES)
        return out
    parallel_mesh.myers_perrow = timed_perrow
    t = time.perf_counter()
    try:
        with recording(program):
            sd = pipe.decompose(world.monomers, recruited)
    finally:
        parallel_mesh.myers_perrow = perrow
    torch.cuda.synchronize()
    seconds["decomposition"] = time.perf_counter() - t
    # the device's time of the samples the host queued ahead of the card
    # (a host stall longer than the spin leaves a sample timing the host)
    k4_ms = [e0.elapsed_time(e1) for (e0, e1), q in zip(events, queued)
             if q]
    launches = {**k1_launches, **{k: kernel.launches
                                  for k, kernel in KERNELS.items()
                                  if k not in k1_launches}}
    batches = -(-len(recruited) // MonomerDecomposerConfig().batch_reads)
    first_steps = sum(c == "all" for _, c in steps)
    calls, correct, flipped = call_accuracy(world, sd)
    stage_s, stage_calls, polished = {}, {}, []
    t = time.perf_counter()
    with timed_mono(mono_pipeline, consensus, stage_s, stage_calls,
                    polished):
        asm = pipe.run(sd, dict(recruited))
    run_s = time.perf_counter() - t
    seconds.update(stage_s)
    seconds["run_other"] = run_s - sum(stage_s.values())
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    at, units = pseudounit_divergence(world,
                                      stage_calls["polish_scaffolds"],
                                      polished, pipe.config.polish_n_iter)
    edits = sum(e for e, _ in units)
    span = sum(n for _, n in units)
    covered = np.zeros(len(world.syms), bool)
    for p, s in zip(at, asm.scaffolds_mono):
        if p >= 0:
            covered[p:p + len(s)] = True
    scaffold_fn = os.path.join(outdir, "polishing", "scaffold_0",
                               "scaffold_0.fasta")
    digests = {"scaffold_0": sha256_of(scaffold_fn) if os.path.exists(
        scaffold_fn) else None,
               "idb": tree_digest(os.path.join(outdir, "idb"))}
    out = {"phase": "cen6_pipeline", "reads_mbp": mbp,
           "world_reads": len(world_ids), "background_reads":
           len(background), "recruited": n_rec,
           "exact_tier_equal": rec_ids == exact_set,
           "exact_tier_seconds": exact_s, "launches": launches,
           "decomposition_seconds": seconds["decomposition"],
           "decomposition_mbp_per_s": sum(len(s) for _, s in recruited)
           / seconds["decomposition"] / 1e6, "decomposition_steps":
           launches["k4"], "decomposition_batches": batches,
           "k4_windows_mean": float(np.mean([w for w, _ in steps]))
           if steps else None,
           "k4_windows_max": max((w for w, _ in steps), default=None),
           "k4_sampled_steps": len(events),
           "k4_sampled_queued": len(k4_ms),
           "k4_spin_cycles": spin[0],
           "k4_ms_mean": float(np.mean(k4_ms)) if k4_ms else None,
           "k4_ms_max": max(k4_ms, default=None),
           "k4_ms_total_estimate": float(np.mean(k4_ms)) * launches["k4"]
           if k4_ms else None,
           "k1_fused_step": fused,
           "monostrings": len(sd.monostrings), "calls": calls,
           "call_accuracy": correct / max(calls, 1),
           "plus_reads_flipped": flipped,
           "scaffolds": [len(s) for s in asm.scaffolds_mono],
           "scaffold_at": at, "array_monomers": len(world.syms),
           "recovered_frac": float(covered.mean()),
           "pseudounits": len(units), "pseudounit_edits": edits,
           "pseudounit_bp": span, "divergence": edits / max(span, 1),
           "pseudounit_max_divergence": max(
               (e / n for e, n in units), default=0.0),
           "scaffold_bp": [len(s) for s in asm.scaffolds_nucl],
           "stage_seconds": seconds, "run_seconds": run_s,
           "program_seconds": {k: program.seconds(k)
                               for k in sorted(program.spans)},
           "program_counts": dict(program.counters),
           "check_seconds": time.perf_counter() - t,
           "max_memory_allocated": peak, "sha256": digests,
           "equal_jax": {k: None if w is None else digests[k] == w
                         for k, w in zip(digests, want)},
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(launches["sf"] == launches["k1c"], f"the seed filter kernel "
          f"launched {launches['sf']} times in {launches['k1c']} fused steps "
          f"of cen6's recruitment")
    check(launches["k1c"] > 0, "cen6 recruitment's fused step launched K1c "
          "no time")
    check(launches["k4"] > 0, "the cen6 decomposition launched K4 no time")
    check(program.counters["decomposer.steps"] == launches["k4"],
          f"{program.counters['decomposer.steps']} decomposer steps for "
          f"{launches['k4']} K4 launches")
    check(first_steps == batches and len(steps) == launches["k4"],
          f"{first_steps} first steps (HW/all) for {batches} lockstep "
          f"batches of {len(recruited)} reads")
    check(len(k4_ms) >= 0.9 * len(events) > 0, f"{len(k4_ms)} of "
          f"{len(events)} sampled K4 launches queued ahead of the device")
    check(rec_ids == world_ids,
          f"recruited: {len(world_ids - rec_ids)} world reads missed, "
          f"{len(rec_ids - world_ids)} other reads taken")
    check(rec_ids == exact_set, f"recruited != the exact tier's set: "
          f"{sorted(rec_ids ^ exact_set)[:10]}")
    check(calls and correct >= CEN6_MIN_ACCURACY * calls,
          f"call accuracy {correct}/{calls}")
    check(asm.scaffolds_mono and min(at) >= 0,
          f"scaffolds not exact runs of the array: at {at}")
    check(units and edits <= CEN6_MAX_DIVERGENCE * span,
          f"pseudounits: {edits} edits over {span} bp")
    for (name, got), w in zip(digests.items(), want):
        check(w is None or got == w,
              f"{name} differs from the JAX package's files for this world")
    return launches, k1_instance, sd, out


MONO_FRESH_UNITS = 6        # tests/test_mono_e2e.py's world
MONO_FRESH_LEN = 60


def mono_fresh_world():
    """tests/test_mono_e2e.py's world and reads: 6 random 60-bp monomers,
    40 HOR copies with 14 variant positions (seed 11); reads of 12
    monomers every 4, every third reverse-complemented, 3% noise (seed
    21). -> (monomers, genome symbols, genome, reads)."""
    rng = np.random.default_rng(11)
    monomers = {f"m{i}": gen_random_seq(rng, MONO_FRESH_LEN)
                for i in range(MONO_FRESH_UNITS)}
    mono_seqs = list(monomers.values())
    syms = np.array(list(range(MONO_FRESH_UNITS)) * 40, np.int16)
    for pos in rng.choice(len(syms), size=14, replace=False):
        cur = int(syms[pos])
        choices = [x for x in range(MONO_FRESH_UNITS) if x != cur]
        syms[pos] = choices[int(rng.integers(0, MONO_FRESH_UNITS - 1))]
    g = "".join(mono_seqs[int(s)] for s in syms)
    rng = np.random.default_rng(21)
    reads, i = {}, 0
    read_len, stride = 12 * MONO_FRESH_LEN, 4 * MONO_FRESH_LEN
    for start in range(0, len(g) - read_len + 1, stride):
        seq = g[start:start + read_len]
        if i % 3 == 1:
            seq = revcomp_str(seq)
        reads[f"r{i:03d}"] = add_read_noise(rng, seq, 0.03)
        i += 1
    return monomers, syms, g, reads


def mono_fresh_config():
    """tests/test_mono_e2e.py's MonoConfig."""
    return MonoConfig(min_k=3, max_k=8, min_mult=3, polish_n_iter=2,
                      hor_min_mult=200, min_uniq_len=6, max_uniq_cov=100,
                      cut_min_length=8)


def phase_cen6_fresh(dev):
    """MonoPipeline at tests/test_mono_e2e.py's world and config
    (`mono_fresh_world`, `mono_fresh_config`), its decomposer and its
    run, on the card and on the CPU: the SDReports equal, every file
    equal, K4 launched."""
    t0 = time.perf_counter()
    monomers, _, _, reads = mono_fresh_world()
    files, sds, seconds = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for where, d in (("card", dev), ("cpu", "cpu")):
            out = os.path.join(tmp, where)
            t = time.perf_counter()
            myers_perrow.launches = 0
            pipe = MonoPipeline(mono_fresh_config(), out, device=d)
            sd = pipe.decompose(monomers, reads.items())
            pipe.run(sd, reads)
            seconds[where] = {"seconds": time.perf_counter() - t,
                              "k4_launches": myers_perrow.launches}
            sds[where] = {r: (m.syms.tolist(), m.nucl.tolist(), m.strand)
                          for r, m in sd.monostrings.items()}
            files[where] = file_digests(out, skip=())
    same = files["card"] == files["cpu"]
    emit({"phase": "cen6_fresh", "reads": len(reads),
          "files": len(files["card"]), "identical": same,
          "sd_equal": sds["card"] == sds["cpu"], "runs": seconds,
          "seconds": time.perf_counter() - t0})
    check(seconds["card"]["k4_launches"] > 0,
          "cen6_fresh: the card's run launched K4 no time")
    check(sds["card"] == sds["cpu"], "cen6_fresh: the SD records differ")
    check(same and any(f.startswith("polishing") for f in files["card"]),
          f"cen6_fresh: the card's files differ from the CPU's: "
          f"{sorted(k for k in files['card'] if files['card'][k] != files['cpu'].get(k))}")
    return files["card"], sds["card"]


def k5_case(rng, unit_codes, chunk):
    """K5_ROWS rows over two chunks: tandem copies of the unit (rows 0, 2,
    4) and of its reverse complement (1, 3, 5) with 8% substitutions, an
    N run in row 2, random rows 6 and 7; lengths ending inside the first
    chunk, inside the second, at its end, one column before it, past the
    text, and 0."""
    m, L = len(unit_codes), 2 * chunk
    codes = rng.integers(0, 4, (K5_ROWS, L)).astype(np.int8)
    for r in range(6):
        src = unit_codes if r % 2 == 0 else revcomp(unit_codes)
        row = np.tile(src, L // m + 1)[:L].copy()
        flip = rng.random(L) < 0.08
        row[flip] = rng.integers(0, 4, int(flip.sum()))
        codes[r] = row
    codes[2, 100:164] = 4
    lens = np.array([L, L, chunk // 2, chunk + 700, L - 1, 5 * L, 0, L],
                    np.int32)
    return codes, lens


def state_err(a, b):
    """max_abs_err over every field of two carried states."""
    return max(int((x.cpu().long() - y.cpu().long()).abs().max())
               for x, y in zip(a, b))


def k5_bound(lens, c0, chunk, words, rate):
    """(bound_ms, bound_by) of one K5 chunk: 11 operations per query word
    for each column a row scores in [c0, c0 + chunk), against its bytes
    (those codes, the lens, the peq table, the state in and out)."""
    cols = int(np.clip(np.asarray(lens, np.int64) - c0, 0, chunk).sum())
    rows = len(lens)
    ops = OPS_PER_WORD_COLUMN * words * cols
    nbytes = cols + 4 * rows + 5 * 4 * words + 2 * rows * (8 * words + 16)
    op_ms, byte_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def k5_per_column():
    """{G: SASS instructions per column} of K5's column loop at DXZ1's
    width, from the built library (tools/probe_myers_wavefront.py)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import probe_myers_wavefront
    per_column = probe_myers_wavefront.per_column(_build.build(), "k5")
    check(sorted(per_column) == sorted(GROUPS), "K5's column loops: "
          f"{per_column}")
    return per_column


def k5_issue_floor(per_column, cols, rate):
    """One warp's issue floor (ms) of a K5 launch whose busiest row
    scores `cols` columns: its column loop's instructions per column at
    one instruction a clock, the card's maximum SM clock (from `rate`)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_column * cols / (rate / (sms * INT32_LANES_PER_SM_CLOCK)) * 1e3


def k5_sweep(dev):
    """K5, every G, against the CPU's plain version at every m of
    K5_M_SWEEP in each mode: a random query, K5_ROWS rows (row 0 tandem
    copies of it, lengths ending before, inside and past the chunk, and
    0), the second of two chunks of K5_SWEEP_CHUNK columns from the
    first's carried state. Returns ({case: max_abs_err}, {m: {G: ms}}),
    timed in HW mode."""
    rng = np.random.default_rng(6)
    C = K5_SWEEP_CHUNK
    lens = torch.tensor([2 * C, 0, C // 2, C + 5, 2 * C - 1, 2 * C, C,
                         5 * C], dtype=torch.int32)
    errs, ms = {}, {}
    for m in K5_M_SWEEP:
        q = rng.integers(0, 4, m).astype(np.int8)
        peq = words_tensor(build_peq(q), "cpu")
        text = rng.integers(0, 5, (K5_ROWS, 2 * C)).astype(np.int8)
        text[0] = np.tile(q, 2 * C // m + 2)[:2 * C]
        text = torch.from_numpy(text)
        args = (peq.to(dev), text[:, C:].to(dev), lens.to(dev))
        for mode in ("HW", "SHW", "NW"):
            mid = myers_carry_plain(peq, text[:, :C], lens,
                                    carry_init(K5_ROWS, m, "cpu"), 0, m=m,
                                    mode=mode)
            want = myers_carry_plain(peq, text[:, C:], lens, mid, C, m=m,
                                     mode=mode)
            for g in GROUPS:
                got = myers_carry(*args, mid.to(dev), C, m=m, mode=mode,
                                  group=g)
                errs[f"{mode}_m{m}_g{g}_cpu"] = state_err(got, want)
            if mode == "HW":
                mid_d = mid.to(dev)
                ms[m] = {g: time_cuda(lambda g=g: myers_carry(
                    *args, mid_d, C, m=m, mode="HW", group=g), reps=10)
                    for g in GROUPS}
    return errs, ms


def k5_by_group(peq, text, m, reps):
    """K5 on (B, C) `text` of full-length rows from the initial state,
    HW, every G: the states must agree. Returns ({G: state}, {G: ms})."""
    B, C = text.shape
    lens = torch.full((B,), C, dtype=torch.int32, device=text.device)
    st = carry_init(B, m, text.device)
    outs = {g: myers_carry(peq, text, lens, st, 0, m=m, group=g)
            for g in GROUPS}
    check(all(state_err(outs[g], outs[GROUPS[0]]) == 0 for g in GROUPS),
          f"K5's lane groups differ on {B} x {C}")
    ms = {g: time_cuda(lambda g=g: myers_carry(peq, text, lens, st, 0, m=m,
                                               group=g), reps=reps)
          for g in GROUPS}
    return outs, ms


def noisy_tandem(rng, unit_codes, rows, L):
    """`rows` rows of L codes: tandem copies of the unit with 10%
    substitutions."""
    codes = np.tile(unit_codes, L // len(unit_codes) + 1)[:L]
    codes = np.repeat(codes[None], rows, axis=0)
    flip = rng.random(codes.shape) < 0.10
    return np.where(flip, rng.integers(0, 4, codes.shape), codes).astype(
        np.int8)


def k5_long(unit_codes, dev, rate, per_column):
    """One tandem DXZ1 row of K5_LONG columns (the tier's launch width)
    by G (`k5_by_group`), with the picked G's time, the bound and the
    issue floor."""
    m = len(unit_codes)
    peq = words_tensor(build_peq(unit_codes), dev)
    text = torch.from_numpy(noisy_tandem(np.random.default_rng(7),
                                         unit_codes, 1, K5_LONG)).to(dev)
    outs, ms = k5_by_group(peq, text, m, reps=3)
    G = pick_group(1, 1)
    bound_ms, bound_by = k5_bound([K5_LONG], 0, K5_LONG, peq.shape[1], rate)
    return {"rows": 1, "chunk": K5_LONG, "c0": 0, "mode": "HW",
            "best": int(outs[G].best[0]), "groups_equal": True, "group": G,
            "ms": ms[G], "ms_by_group": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "issue_floor_ms": k5_issue_floor(
                per_column[G], K5_LONG, rate)}


def k5_wide(unit_codes, dev):
    """K5_WIDE rows of K5_CHUNK columns (every other row tandem DXZ1, the
    rest random) by G (`k5_by_group`). Returns {rows: {G: ms}}."""
    rng = np.random.default_rng(8)
    peq = words_tensor(build_peq(unit_codes), dev)
    out = {}
    for B in K5_WIDE:
        codes = rng.integers(0, 4, (B, K5_CHUNK)).astype(np.int8)
        codes[::2] = noisy_tandem(rng, unit_codes, (B + 1) // 2, K5_CHUNK)
        _, out[B] = k5_by_group(peq, torch.from_numpy(codes).to(dev),
                                len(unit_codes), reps=5)
    return out


def phase_k5(unit_codes, dev, rate):
    """K5, every G, against its plain version on the card: two chunks of
    K5_CHUNK columns of `k5_case` in each mode, the second from the
    first's state (a strided view of the text), the whole carried state
    compared; then `k5_sweep` against the CPU's plain version. Times
    every G in HW mode on the second chunk and on one row of K5_LONG
    columns (`k5_long`), beside the bound and the picked G's issue floor,
    and on K5_WIDE rows (`k5_wide`). Returns the kernel's fields."""
    rng = np.random.default_rng(5)
    m, C = len(unit_codes), K5_CHUNK
    codes, lens = k5_case(rng, unit_codes, C)
    text, lens_t = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(
        dev)
    peq = words_tensor(build_peq(unit_codes), dev)
    errs, plain_ms = {}, {}
    for mode in ("HW", "SHW", "NW"):
        st = carry_init(K5_ROWS, m, dev)
        want1 = myers_carry_plain(peq, text[:, :C], lens_t, st, 0, m=m,
                                  mode=mode)
        want2, plain_ms[mode] = timed_plain(lambda: myers_carry_plain(
            peq, text[:, C:], lens_t, want1, C, m=m, mode=mode))
        for g in GROUPS:
            got1 = myers_carry(peq, text[:, :C], lens_t, st, 0, m=m,
                               mode=mode, group=g)
            got2 = myers_carry(peq, text[:, C:], lens_t, want1, C, m=m,
                               mode=mode, group=g)
            errs[f"{mode}_g{g}"] = max(state_err(got1, want1),
                                       state_err(got2, want2))
        if mode == "HW":
            mid = want1
    sweep_errs, sweep_ms = k5_sweep(dev)
    errs.update(sweep_errs)
    err = max(errs.values())
    wrong = {k: v for k, v in errs.items() if v}
    check(err == 0, f"K5 != its plain version: {wrong}")
    per_column = k5_per_column()
    ms = {g: time_cuda(lambda g=g: myers_carry(
        peq, text[:, C:], lens_t, mid, C, m=m, mode="HW", group=g), reps=10)
        for g in GROUPS}
    G = pick_group(K5_ROWS, 1)
    bound_ms, bound_by = k5_bound(lens, C, C, peq.shape[1], rate)
    cols = int(np.clip(lens - C, 0, C).max())
    return {"m": m, "rows": K5_ROWS, "chunk": C, "max_abs_err": err,
            "errors": errs, "group": G, "ms": ms[G], "ms_by_group": ms,
            "issue_floor_ms": k5_issue_floor(per_column[G], cols, rate),
            "sass_per_column": per_column, "plain_ms": plain_ms["HW"],
            "plain_ms_by_mode": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "sweep_ms_by_group": sweep_ms,
            "long": k5_long(unit_codes, dev, rate, per_column),
            "wide_ms_by_group": k5_wide(unit_codes, dev)}


def long_reads(unit):
    """LONG_READS reads of LONG_LEN: even ones tandem copies of the unit
    with 10% noise, odd ones random. Returns them and the tandem ids."""
    rng = np.random.default_rng(LONG_SEED)
    reads = []
    for i, L in enumerate(rng.integers(LONG_LEN[0], LONG_LEN[1] + 1,
                                       LONG_READS)):
        L = int(L)
        seq = (add_read_noise(rng, unit * (L // len(unit) + 2), 0.10)[:L]
               if i % 2 == 0 else gen_random_seq(rng, L))
        reads.append((f"long{i}", seq))
    return reads, {r for i, (r, _) in enumerate(reads) if i % 2 == 0}


DIST_WORKER = """
import sys
import torch.distributed as dist
from centroflye_tpu_torch.parallel.distributed import init_distributed
from centroflye_tpu_torch.stages.recruitment import recruit_file
store, rank, n, unit_fn, reads_fn, out_fn, threshold, batch, seg, dev = \\
    sys.argv[1:]
assert init_distributed("file://" + store, int(n), int(rank))
print(recruit_file(unit_fn, reads_fn, out_fn, int(threshold),
                   batch_size=int(batch), seg_len=int(seg), device=dev,
                   mesh=None, distributed=True), flush=True)
dist.destroy_process_group()
"""


def run_distributed(reads_fn, out_fn, store, dev):
    """recruit_file(..., distributed=True) in DIST_PROCESSES processes of
    one gloo group (a file store), each on `dev`. Returns process 0's
    count and the processes' seconds; every process is ended."""
    t0 = time.perf_counter()
    args = [str(DIST_PROCESSES), UNIT_FASTA, reads_fn, out_fn,
            str(THRESHOLD), str(BATCH_SIZE), str(SEG_LEN), str(dev)]
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, store,
                               str(rank), *args], cwd=HERE, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(DIST_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        check(p.returncode == 0, f"a recruit_file process failed: "
              f"{err[-2000:]}")
    return int(outs[0][0].split()[-1]), time.perf_counter() - t0


@contextlib.contextmanager
def captured_seqpar_k5():
    """Keeps every K5 launch of the sequence-parallel tier (its inputs,
    the state it started from and the state it returned, by reference) in
    the list it yields, for `hold_tier_k5` after the run."""
    captured, carry = [], seq_parallel.myers_carry

    def capture(peq, text, lens, state, c0, *, m, mode):
        out = carry(peq, text, lens, state, c0, m=m, mode=mode)
        captured.append(((peq, text, lens, state, c0), dict(m=m, mode=mode),
                         out))
        return out
    seq_parallel.myers_carry = capture
    try:
        yield captured
    finally:
        seq_parallel.myers_carry = carry


def hold_tier_k5(captured, rate):
    """K5 against its plain version (on the CPU: one row's column loop is
    launch-bound on the card) on the whole carried state of one launch
    of the sequence-parallel tier, at the tier's own shape, every G. Of
    the launches whose rows all have columns in their chunk, it takes one
    with a row within THRESHOLD, then the highest c0 (the state carried
    through the most chunks), then a row ending inside the chunk (frozen
    past its end). Returns its fields: ms by G, the picked G's, and the
    busiest row's columns."""
    check(captured, "the sequence-parallel tier launched K5 no time")

    def key(launch):
        (_, text, lens, _, c0), _, out = launch
        return (bool((lens > c0).all()), int(out.best.min()) <= THRESHOLD,
                c0, bool((lens < c0 + text.shape[1]).any()))
    args, kw, got = max(captured, key=key)
    check(key((args, kw, got))[:2] == (True, True), "no K5 launch of the "
          "tier holds an active row within the threshold")
    peq, text, lens, state, c0 = args
    t = time.perf_counter()
    want = myers_carry_plain(peq.cpu(), text.cpu(), lens.cpu(), state.to(
        "cpu"), c0, **kw)
    plain_ms = (time.perf_counter() - t) * 1e3
    err = max(state_err(got, want), *(state_err(
        myers_carry(*args, **kw, group=g), want) for g in GROUPS))
    check(err == 0, f"K5 != its plain version on the tier's launch at c0 = "
          f"{c0} ({tuple(text.shape)}, {kw})")
    ms = {g: time_cuda(lambda g=g: myers_carry(*args, **kw, group=g),
                       reps=3) for g in GROUPS}
    G = pick_group(text.shape[0], 1)
    bound_ms, bound_by = k5_bound(lens.cpu().numpy(), c0, text.shape[1],
                                  peq.shape[1], rate)
    return {"rows": text.shape[0], "chunk": text.shape[1], "c0": c0,
            "lens": lens.cpu().tolist(), "best": got.best.cpu().tolist(),
            "mode": kw["mode"], "launches_captured": len(captured),
            "max_abs_err": err, "group": G, "ms": ms[G], "ms_by_group": ms,
            "cols": int((lens.cpu() - c0).clamp(0, text.shape[1]).max()),
            "plain_cpu_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_mesh(unit, reads, recruited, distances, cenx_files, mono_files,
               dev, rate):
    """Multi-device execution with the card as every device of the mesh:
    K5 against its plain version (`phase_k5`); main_path's mix through
    the engine on a MESH_SHARDS-shard mesh (the fused step sharded, K1 on
    each shard) gives main_path's per-read distances with the seq-par
    tier off, and with the default config (prefilter and seq-par tier
    on) main_path's recruited set, its distances below
    seq_parallel_min_len and the exact tier's at and above it; LONG_READS
    long reads through the mesh engine's sequence-parallel tier (K5) give
    the single-device engine's segmented distances (prefilter off in
    both), and one of that run's last-stage K5 launches equals the plain
    version on the whole carried state (`hold_tier_k5`);
    recruit_file(distributed=True) in DIST_PROCESSES gloo processes
    writes the single-process file byte for byte; CenXPipeline on
    cenx_fresh's world and the cen6 decomposer on cen6_fresh's world, on
    2-shard meshes, write the single-device card runs' files; and the dry
    run on a MESH_SHARDS-device mesh. Returns K5's fields and launches."""
    t0 = time.perf_counter()
    seconds = {}
    t = time.perf_counter()
    k5 = phase_k5(encode(unit), dev, rate)
    seconds["k5"] = time.perf_counter() - t
    mesh = make_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    mesh2 = make_mesh(2, devices=[dev] * 2)

    t = time.perf_counter()
    # the fused tier alone (seq-par tier off): every read's distances are
    # main_path's
    cfg = RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE,
                            seq_parallel_min_len=0)
    engine = RecruitmentEngine(unit, cfg, seg_len=SEG_LEN, device=dev,
                               mesh=mesh)
    myers_hw_chunks.launches = 0
    got = [(r.r_id, r.dist_fwd, r.dist_rc) for r in engine.run(reads)]
    torch.cuda.synchronize()
    k1c_sharded = myers_hw_chunks.launches
    seconds["fused_mesh"] = time.perf_counter() - t
    check(engine.mesh.size == MESH_SHARDS and engine._fused.n_dev ==
          MESH_SHARDS, "the engine did not take the mesh")
    check(k1c_sharded > 0, "the sharded fused step launched K1c no time")
    want = distances["prefilter"]
    check(got == want, "the sharded engine's distances differ from "
          f"main_path's: {[a for a, b in zip(got, want) if a != b][:5]}")

    # the configuration a multi-card user runs: the prefilter and the
    # seq-par tier both on. Reads below seq_parallel_min_len keep
    # main_path's distances; the longer ones, which skip the host
    # prescan, get the exact tier's; the recruited set is main_path's
    t = time.perf_counter()
    cfg = RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE)
    engine = RecruitmentEngine(unit, cfg, seg_len=SEG_LEN, device=dev,
                               mesh=mesh)
    myers_carry.launches = 0
    results = list(engine.run(reads))
    torch.cuda.synchronize()
    k5_default = myers_carry.launches
    seconds["default_mesh"] = time.perf_counter() - t
    long_ids = {r for r, s in reads if len(s) >= engine.seqpar_min}
    want = [e if e[0] in long_ids else p for p, e in
            zip(distances["prefilter"], distances["exact"])]
    got = [(r.r_id, r.dist_fwd, r.dist_rc) for r in results]
    mesh_set = {r.r_id for r in results if r.recruited}
    check(long_ids and k5_default > 0, f"{len(long_ids)} reads of main_path "
          f"took the seq-par tier, K5 launched {k5_default} times")
    check(got == want, "the default mesh engine's distances differ: "
          f"{[(a, b) for a, b in zip(got, want) if a != b][:5]}")
    check(mesh_set == recruited, "the default mesh engine recruited "
          f"{sorted(mesh_set ^ recruited)[:10]} unlike main_path")

    t = time.perf_counter()
    longs, tandem = long_reads(unit)
    exact = RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE,
                              prefilter=False)
    want = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
            for r in RecruitmentEngine(unit, exact, seg_len=PIPELINE_SEG_LEN,
                                       device=dev, mesh=None).run(longs)]
    seg_s = time.perf_counter() - t
    t = time.perf_counter()
    engine = RecruitmentEngine(unit, exact, seg_len=PIPELINE_SEG_LEN,
                               device=dev, mesh=mesh)
    check(engine.seqpar_min == exact.seq_parallel_min_len
          and min(len(s) for _, s in longs) >= engine.seqpar_min,
          "the long reads do not take the sequence-parallel tier")
    myers_carry.launches = 0
    with captured_seqpar_k5() as tier_launches:
        got = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
               for r in engine.run(longs)]
        torch.cuda.synchronize()
    k5_launches = myers_carry.launches
    seconds["seqpar"] = time.perf_counter() - t
    check(k5_launches > 0, "the sequence-parallel tier launched K5 no time")
    check(got == want, f"seq-par distances {got} != segmented {want}")
    check({r for r, _, _, rec in got if rec} == tandem,
          f"seq-par recruited {[r for r, _, _, rec in got if rec]}")
    t = time.perf_counter()
    k5["tier_launch"] = tier = hold_tier_k5(tier_launches, rate)
    tier["issue_floor_ms"] = k5_issue_floor(
        k5["sass_per_column"][tier["group"]], tier["cols"], rate)
    del tier_launches
    seconds["tier_launch"] = time.perf_counter() - t
    k5["max_abs_err"] = max(k5["max_abs_err"],
                            k5["tier_launch"]["max_abs_err"])

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reads_fn = os.path.join(tmp, "reads.fasta")
        write_seqs(reads_fn, dict(reads[:CLI_READS]))
        single_fn = os.path.join(tmp, "single.fasta")
        n_single = recruit_file(UNIT_FASTA, reads_fn, single_fn, THRESHOLD,
                                batch_size=BATCH_SIZE, seg_len=SEG_LEN,
                                device=dev, mesh=None)
        out_fn = os.path.join(tmp, "distributed.fasta")
        n_dist, dist_s = run_distributed(reads_fn, out_fn,
                                         os.path.join(tmp, "store"), dev)
        same_file = sha256_of(single_fn) == sha256_of(out_fn)
    seconds["distributed"] = time.perf_counter() - t
    check(n_dist == n_single > 0 and same_file,
          f"{DIST_PROCESSES} processes wrote {n_dist} reads, one wrote "
          f"{n_single}; files equal: {same_file}")

    t = time.perf_counter()
    unit_f, _, reads_f = fresh_world()
    with tempfile.TemporaryDirectory() as tmp:
        reads_fn = os.path.join(tmp, "reads.fasta")
        write_seqs(reads_fn, reads_f)
        out = os.path.join(tmp, "out")
        CenXPipeline(unit_f, fresh_config(), out, device=dev,
                     mesh=mesh2).run(reads_fn)
        cenx_mesh = file_digests(out)
    seconds["cenx_mesh"] = time.perf_counter() - t
    check(cenx_mesh == cenx_files, "CenXPipeline on a 2-shard mesh: files "
          f"differ: {sorted(k for k in cenx_files if cenx_mesh.get(k) != cenx_files[k])}")

    t = time.perf_counter()
    monomers, _, _, reads6 = mono_fresh_world()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        pipe = MonoPipeline(mono_fresh_config(), out, device=dev)
        myers_perrow.launches = 0
        sd = pipe.decompose(monomers, reads6.items(), mesh=mesh2)
        k4_sharded = myers_perrow.launches
        pipe.run(sd, reads6)
        mono_mesh = file_digests(out, skip=())
    seconds["cen6_mesh"] = time.perf_counter() - t
    sds = {r: (ms.syms.tolist(), ms.nucl.tolist(), ms.strand)
           for r, ms in sd.monostrings.items()}
    check(k4_sharded > 0, "the sharded decomposer launched K4 no time")
    check(sds == mono_files[1] and mono_mesh == mono_files[0],
          "the 2-shard decomposer's SDReport or files differ")

    t = time.perf_counter()
    dry = dryrun_multichip(MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    seconds["dryrun"] = time.perf_counter() - t
    emit({"phase": "mesh", "shards": MESH_SHARDS,
          "k5": {k: v for k, v in k5.items() if k != "library_ms"},
          "fused_mesh": {"reads": len(reads), "equal": True,
                         "k1c_launches": k1c_sharded},
          "default_mesh": {"reads": len(reads), "recruited": len(mesh_set),
                           "seqpar_reads": len(long_ids),
                           "k5_launches": k5_default, "equal": True},
          "seqpar": {"reads": len(longs), "mbp": sum(
              len(s) for _, s in longs) / 1e6, "equal": True,
              "k5_launches": k5_launches, "segmented_seconds": seg_s},
          "distributed": {"processes": DIST_PROCESSES,
                          "reads": CLI_READS, "recruited": n_dist,
                          "identical": True, "processes_seconds": dist_s},
          "cenx_mesh_files": len(cenx_mesh), "cen6_mesh_files":
          len(mono_mesh), "cen6_k4_launches": k4_sharded, "dryrun": dry,
          "phase_seconds": seconds, "seconds": time.perf_counter() - t0})
    return k5, k5_launches


def valid_score(cfg, score0, score1):
    """The placement rule (stages/placement_fast.FastPlacer._valid_key)."""
    return (score1 >= 1 and score0 >= cfg.min_unit
            and score1 >= cfg.min_inters and score1 >= cfg.min_prop * score0)


def once_in_array(arr, k):
    """The k-mers that occur once in the simulated array, and where."""
    codes, valid = kmer_codes(arr, k)
    u, first, cnt = np.unique(codes[valid], return_index=True,
                              return_counts=True)
    return u[cnt == 1], np.flatnonzero(valid)[first][cnt == 1]


def unique_by_unit(world, codes, k):
    """Per unit of the simulated array, how many of `codes` occur in it
    and nowhere else in the array."""
    once, pos = once_in_array(world.arr, k)
    return np.bincount(pos[np.isin(once, codes)] // world.unit_len,
                       minlength=world.arr.size // world.unit_len)


def main():
    smi_line, kind = phase_device()
    dev = torch.device("cuda")
    rate = int32_ops_per_s()
    phase_build()
    unit = read_seq(UNIT_FASTA)
    m = len(unit)
    k1, k1_state = phase_k1(encode(unit), dev, rate)
    k1c = phase_k1c(dev, rate)
    sf = phase_seed_filter(dev)
    k2 = phase_k2(k1_state, k1["ms"], m, rate)
    k3 = phase_k3(encode(unit), dev, k1["ms"], k2["ms"], rate)
    k4 = phase_k4(dev, rate)
    myers_carry.launches = 0
    reads, recruited, launches, batches, overlap, distances = \
        phase_main_path(unit, dev)
    k5_by_path = {"main_path": myers_carry.launches}
    phase_cli(reads, recruited, dev)
    ops_launches, at_2048 = phase_myers_ops(unit, reads, recruited, batches,
                                            overlap, dev, rate)
    cenx_files = phase_cenx_fresh(dev)
    t = time.perf_counter()
    world = make_world(unit, N_UNITS)
    world_s = time.perf_counter() - t
    boundary_dec = phase_decomposition(unit, world)
    # stages 2-4's artifacts outlive their phases: the pipeline resumes
    # from them
    with tempfile.TemporaryDirectory() as outdir:
        res, dec = phase_unique_kmers(unit, dev, world, world_s,
                                      boundary_dec, outdir)
        phase_placement(world, dec, res, dev, outdir)
        del res, dec
        background = [(r, s) for r, s in reads if r not in recruited]
        myers_carry.launches = 0
        pipeline_launches, k1_pipeline, _ = phase_cenx_pipeline(
            unit, world, background, dev, outdir, rate)
        k5_by_path["cenx_pipeline"] = myers_carry.launches
    del world
    mono_files = phase_cen6_fresh(dev)
    t = time.perf_counter()
    world6 = cen6_world()
    emit({"phase": "cen6_world", "reads": len(world6.reads),
          "mbp": sum(len(s) for _, s in world6.reads) / 1e6,
          "array_monomers": len(world6.syms),
          "array_bp": int(world6.bounds[-1]),
          "seconds": time.perf_counter() - t})
    with tempfile.TemporaryDirectory() as outdir:
        myers_carry.launches = 0
        cen6_launches, k1_cen6, _, _ = phase_cen6_pipeline(
            world6, reads, dev, outdir, rate)
        k5_by_path["cen6_pipeline"] = myers_carry.launches
    del world6
    check(not any(k5_by_path.values()), f"K5 launched on a one-card path "
          f"(auto_mesh is None there): {k5_by_path}")
    k5, k5_by_path["mesh"] = phase_mesh(unit, reads, recruited, distances,
                                        cenx_files, mono_files, dev, rate)
    for kernel, key in ((k1, "k1"), (k2, "k2"), (k3, "k3")):
        kernel.setdefault("instances", {}).update(at_2048[key])
    k1c["instances"].update(k1_pipeline)
    k1c["instances"].update(k1_cen6)
    k1c["max_abs_err"] = max(k1c["max_abs_err"], *(
        i["max_abs_err"] for i in (*k1_pipeline.values(),
                                   *k1_cen6.values())))
    by_path = {"k1": {"main_path": launches["k1"]},
               "k1c": {"main_path": launches["k1c"]},
               "sf": {"main_path": launches["sf"]},
               "k2": {"myers_ops": ops_launches["k2"]},
               "k3": {"myers_ops": ops_launches["k3"]}, "k4": {}}
    for key, n in pipeline_launches.items():
        by_path[key]["cenx_pipeline"] = n
    for key, n in cen6_launches.items():
        by_path[key]["cen6_pipeline"] = n
    emit({"kernels": [
        {"name": "myers_hw_2strand", "route": "cuda",
         "source": f"{CSRC}/myers_hw_2strand.cu", "replaces": K1_REPLACES,
         "launches": launches["k1"], "launches_by_path": by_path["k1"],
         **k1},
        {"name": "myers_hw_chunks", "route": "cuda",
         "source": f"{CSRC}/myers_hw_chunks.cu", "replaces": K1C_REPLACES,
         "launches": launches["k1c"], "launches_by_path": by_path["k1c"],
         **k1c},
        {"name": "seed_filter_compact", "route": "cuda",
         "source": f"{CSRC}/seed_filter.cu", "replaces": SF_REPLACES,
         "launches": launches["sf"], "launches_by_path": by_path["sf"],
         **sf},
        {"name": "myers_hw_v3", "route": "cuda",
         "source": f"{CSRC}/myers_hw_2strand.cu", "replaces": K2_REPLACES,
         "launches": ops_launches["k2"], "launches_by_path": by_path["k2"],
         **k2},
        {"name": "myers_hw_v3_banded", "route": "cuda",
         "source": f"{CSRC}/myers_hw_banded.cu", "replaces": K3_REPLACES,
         "launches": ops_launches["k3"], "launches_by_path": by_path["k3"],
         **k3},
        {"name": "myers_perrow", "route": "cuda",
         "source": f"{CSRC}/myers_perrow.cu", "replaces": K4_REPLACES,
         "launches": cen6_launches["k4"], "launches_by_path": by_path["k4"],
         **k4},
        {"name": "myers_carry", "route": "cuda",
         "source": f"{CSRC}/myers_carry.cu", "replaces": K5_REPLACES,
         "launches": k5_by_path["mesh"], "launches_by_path": k5_by_path,
         **k5}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
