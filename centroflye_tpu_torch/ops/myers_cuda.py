"""HW Myers on the card: the counterpart of the JAX package's
`ops/myers_pallas_v3.py`.

| wrapper | CUDA source | replaces |
|---|---|---|
| `myers_hw_2strand` (and `recruit_distances`) | `csrc/myers_hw_2strand.cu` | `myers_hw_pallas_v3_2strand`, `recruit_distances_pallas` |
| `myers_hw_v3` | `csrc/myers_hw_2strand.cu` (one strand) | `myers_hw_pallas_v3` |
| `myers_hw_v3_banded` | `csrc/myers_hw_banded.cu` | `myers_hw_pallas_v3_banded` |
| `myers_perrow` (K4) | `csrc/myers_perrow.cu` | `ops/myers.py::myers_distance_batch` with per-row queries (a `jnp` scan, no Pallas kernel) |
| `myers_carry` (K5) | `csrc/myers_carry.cu` | `parallel/seq_parallel.py`'s chunk_scan (a `jnp` scan, no Pallas kernel) |

Each wrapper launches its kernel for CUDA tensors and counts the launch
in its `launches` attribute. The two-strand and one-strand wrappers run
one kernel template in instances of G = 8 or 32 lanes per
(row, strand): `pick_group` chooses G from the batch, and the keyword
`group` forces one. For CPU tensors it runs its plain PyTorch
version (`*_plain`, built on `ops/myers.myers_distance_batch`), which is
also what the kernel is compared with on the card. Nothing falls back: on
a CUDA tensor a wrapper launches its kernel or raises.

The threshold-k wrapper runs `banded_plan`'s two passes (`BandedRun`): a
prefix filter on the first r0 query rows, then the survivors on all m
rows, each pass in column windows where the rows alone leave the card
short of work. `myers_hw_v3_banded_split_plain` carries the plan out in
plain torch for the tests.

K4, `myers_perrow`, scores every text window against every query of a
set (the monomer decomposer's lockstep step: both strands of every
monomer against each read's window), in SHW mode choosing each window's
call on the card (the query of least dist / m and its row's dist and
end) or in HW mode collecting the score after every column. Its query
set (`perrow_queries`) is checked and laid out once, not at every step.

K5, `myers_carry`, runs one chunk of text columns for B rows from a
carried DP state (`ops/myers.CarryState`) and returns the new state: the
sequence-parallel tier's step (`parallel/seq_parallel.py`), in HW, SHW
and NW modes. Like K1 it is a wavefront over G = 8 or 32 lanes a row
(`pick_group(B, 1)`, or the keyword `group`), with the state in its
canonical layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from centroflye_tpu_torch.ops._build import load_library
from centroflye_tpu_torch.ops.myers import (
    CarryState, int32_words, myers_carry_plain, myers_distance_batch,
    n_words)

MAX_WORDS = 4 * 32      # m <= 4096
GROUPS = (8, 32)        # lanes per (row, strand) of myers_hw_2strand.cu
SMALL_BATCH = 512       # (row, strand) problems at or below which G = 32


def pick_group(B: int, strands: int) -> int:
    """Lanes per (row, strand) for a batch of B rows, for K1, K2 and K5.
    Up to SMALL_BATCH problems, G = 32 gives each problem a warp and each
    warp its own scheduler (the H100 has 528), and the time is one warp's
    chain of dependent steps, which 32 lanes make the shortest. Above it
    the warps share schedulers and integer issue sets the time: G = 8 has
    the fewest idle word slots and the least fixed work per word.
    Measured for K1 at 128 and 2048 rows on DXZ1 (W = 65 words); for K5
    (one strand) at 1, 8 and 512 rows (G = 32 faster, at 8 rows for every
    m from 1 to 4096) and at 2048 rows (G = 8 faster) (PERF.md)."""
    return 32 if B * strands <= SMALL_BATCH else 8


def _group(group, B: int, strands: int) -> int:
    """The instance for B rows: `group` if given (checked), else the pick."""
    if group is None:
        return pick_group(B, strands)
    if group not in GROUPS:
        raise ValueError(f"group={group}: one of {GROUPS} or None")
    return group


def myers_hw_v3_plain(peq, text_t, lens, *, m: int):
    """Plain PyTorch version of the one-strand kernel: same arguments and
    outputs as `myers_hw_v3`."""
    out = myers_distance_batch(peq, text_t.t(), lens.reshape(-1), m=m,
                               mode="HW")
    return {"dist": out["dist"], "end": out["end"]}


def threshold_hw(out: dict, *, m: int, k: int) -> dict:
    """{"dist", "end"} -> the same where dist <= k, (m, -1) elsewhere."""
    ok = out["dist"] <= k
    return {"dist": torch.where(ok, out["dist"], m),
            "end": torch.where(ok, out["end"], -1)}


def myers_hw_v3_banded_plain(peq, text_t, lens, *, m: int, k: int):
    """Plain PyTorch version of the banded kernel: the unbanded distances
    thresholded at k."""
    return threshold_hw(myers_hw_v3_plain(peq, text_t, lens, m=m), m=m, k=k)


ALPHA = 2.5         # K3's prefix: about ALPHA * (k + 1) query rows
MIN_WINDOW = 1024   # columns a window owns, at least, unless forced
PACKED_NONE = 0xFFFFFFFF    # end -1 as the low word of a packed minimum


class BandedPass(NamedTuple):
    """One pass of K3: `rows` text rows scored on the first q query
    rows, each in `windows` column windows of L columns. Window w owns
    columns [w*S, (w+1)*S) and is scored from w*S - overlap (at least
    0), overlap = q + k - 1: an alignment of cost <= k spans at most
    q + k columns, so the window owning its end scores it exactly."""
    q: int
    rows: int
    L: int
    S: int
    overlap: int
    windows: int

    @property
    def problems(self) -> int:
        return self.rows * self.windows

    def spans(self) -> list:
        """[(c0, lo, hi)]: window w scores [c0, hi) and owns [lo, hi)."""
        return [(max(0, w * self.S - self.overlap), w * self.S,
                 min((w + 1) * self.S, self.L))
                for w in range(self.windows)]


class BandedPlan(NamedTuple):
    r0: int                     # query rows of pass 1 (m: pass 1 is exact)
    pass1: BandedPass           # every row on r0 query rows
    pass2: BandedPass | None    # the survivors on all m; None if r0 == m


def _banded_pass(q: int, k: int, L: int, rows: int, window) -> BandedPass:
    if window is None:
        # as many windows a row as keep rows x windows within SMALL_BATCH
        # problems (the card's schedulers, `pick_group`), none under
        # MIN_WINDOW columns
        per_row = max(1, SMALL_BATCH // max(rows, 1))
        S = max(MIN_WINDOW, -(-L // per_row))
    elif isinstance(window, bool) or not isinstance(window, int) \
            or window < 1:
        raise ValueError(f"window={window!r}: an int >= 1 or None")
    else:
        S = window
    S = max(1, min(S, L))
    return BandedPass(q=q, rows=rows, L=L, S=S, overlap=q + k - 1,
                      windows=max(1, -(-L // S)))


def banded_plan(m: int, k: int, L: int, B: int, *, survivors=None,
                alpha: float = ALPHA, prefix_rows=None,
                window=None) -> BandedPlan:
    """K3's decomposition for B rows of L columns at 0 <= k <= m.

    Pass 1 scores every row on the first r0 query rows, r0 = min(m,
    32 * ceil(alpha * (k + 1) / 32)) (whole words) or `prefix_rows`
    (a multiple of 32 or m). The full distance is at least the prefix's,
    so a row whose prefix distance exceeds k is (m, -1). Pass 2 scores
    the `survivors` rows (B if not yet known) on all m. S is chosen from
    these shapes alone, or forced by `window`."""
    if not 0 <= k <= m:
        raise ValueError(f"k={k}: 0 <= k <= m={m}")
    if prefix_rows is None:
        r0 = min(m, 32 * math.ceil(alpha * (k + 1) / 32))
    elif (isinstance(prefix_rows, bool) or not isinstance(prefix_rows, int)
          or not 1 <= prefix_rows <= m
          or (prefix_rows % 32 and prefix_rows != m)):
        raise ValueError(f"prefix_rows={prefix_rows!r}: a multiple of 32 "
                         f"up to m={m}, or m")
    else:
        r0 = prefix_rows
    pass1 = _banded_pass(r0, k, L, B, window)
    pass2 = None if r0 == m else _banded_pass(
        m, k, L, B if survivors is None else survivors, window)
    return BandedPlan(r0, pass1, pass2)


def _window_minima(peq, text_t, lens, p: BandedPass, rows, k: int):
    """Plain version of one pass on `rows`: each window through
    `myers_distance_batch` on its text slice (all windows in one call),
    combined by the packed minimum of the windows whose distance is
    <= k. -> ((R,) int64 packed minima, (R,) bool: some window <= k)."""
    spans = p.spans()
    width = max(hi - c0 for c0, _, hi in spans)
    n_all = lens.reshape(-1).to(torch.int64).clamp(0, p.L)[rows]
    texts, ns = [], []
    for c0, _, hi in spans:
        t = text_t[c0:hi][:, rows].t()
        texts.append(torch.nn.functional.pad(t, (0, width - (hi - c0)),
                                             value=4))
        ns.append((n_all - c0).clamp(0, hi - c0))
    out = myers_distance_batch(peq[:, :n_words(p.q)].contiguous(),
                               torch.cat(texts), torch.cat(ns), m=p.q,
                               mode="HW")
    R = len(rows)
    d = out["dist"].to(torch.int64).reshape(len(spans), R)
    c0s = torch.tensor([c0 for c0, _, _ in spans]).reshape(-1, 1)
    e = out["end"].to(torch.int64).reshape(len(spans), R)
    e = torch.where(e >= 0, e + c0s, PACKED_NONE)
    hit = d <= k
    packed = torch.where(hit, (d << 32) | e, (p.q << 32) | PACKED_NONE)
    return packed.min(dim=0).values, hit.any(dim=0)


def myers_hw_v3_banded_split_plain(peq, text_t, lens, *, m: int, k: int,
                                   prefix_rows=None, window=None) -> dict:
    """`banded_plan`'s decomposition carried out in plain torch, pass by
    pass and window by window, as the kernel runs it: the tests' model of
    K3's plan. Same outputs as `myers_hw_v3_banded_plain`, plus
    "survivors", pass 1's surviving rows (None when r0 == m)."""
    k = min(k, m)
    L, B = text_t.shape
    plan = banded_plan(m, k, L, B, prefix_rows=prefix_rows, window=window)
    none = (m << 32) | PACKED_NONE
    packed = torch.full((B,), none, dtype=torch.int64)
    survivors = None
    if B:
        rows = torch.arange(B)
        mins, hit = _window_minima(peq, text_t, lens, plan.pass1, rows, k)
        if plan.pass2 is None:
            packed = mins
        else:
            survivors = rows[hit]
            plan = banded_plan(m, k, L, B, survivors=len(survivors),
                               prefix_rows=prefix_rows, window=window)
            if len(survivors):
                packed[survivors] = _window_minima(
                    peq, text_t, lens, plan.pass2, survivors, k)[0]
    d, e = packed >> 32, packed & PACKED_NONE
    ok = (d <= k) & (d < m)
    return {"dist": torch.where(ok, d, m).to(torch.int32),
            "end": torch.where(ok, e, -1).to(torch.int32),
            "survivors": survivors}


def myers_hw_2strand_plain(peq_f, peq_r, text_t, lens, *, m: int):
    """Plain PyTorch version of the two-strand kernel: same arguments and
    outputs."""
    out_f = myers_hw_v3_plain(peq_f, text_t, lens, m=m)
    out_r = myers_hw_v3_plain(peq_r, text_t, lens, m=m)
    return {"dist_f": out_f["dist"], "end_f": out_f["end"],
            "dist_r": out_r["dist"], "end_r": out_r["end"]}


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, text_t on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(peqs: dict, text_t, lens, m: int):
    """Validates a CUDA call's arguments -> (W, L, B, int32 peqs)."""
    dev = text_t.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    W = n_words(m)
    if m < 1 or W > MAX_WORDS:
        raise ValueError(f"m={m}: the kernels take 1 <= m <= "
                         f"{32 * MAX_WORDS}")
    if text_t.dim() != 2:
        raise ValueError(f"text_t must be (L, B), got {tuple(text_t.shape)}")
    L, B = text_t.shape
    _check("text_t", text_t, torch.int8, (L, B), dev)
    for name, peq in peqs.items():
        _check(name, peq, torch.int64, (5, W), dev)
    _check("lens", lens, torch.int32, tuple(lens.shape), dev)
    if lens.numel() != B or lens.dim() not in (1, 2):
        raise ValueError(f"lens shape {tuple(lens.shape)} for B={B}")
    return W, L, B, [int32_words(p) for p in peqs.values()]


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def myers_hw_2strand(peq_f, peq_r, text_t, lens, *, m: int, group=None):
    """HW edit distance of the unit (peq_f) and of its reverse complement
    (peq_r) against each text column of text_t, plus the first column
    that reaches each minimum.

    peq_f, peq_r: (5, W) int64 tensors of 32-bit words (ops/myers.words_tensor);
    text_t: (L, B) int8 codes, 0-3 bases, >= 4 N/PAD; lens: (B,) or (B, 1)
    int32. Columns at or past lens do not move the score. `group` forces
    the kernel's lanes per (row, strand), 8 or 32 (None: `pick_group`).
    Returns {"dist_f", "end_f", "dist_r", "end_r"}, each (B,) int32.
    """
    if text_t.device.type == "cpu":
        _group(group, text_t.shape[1], 2)
        return myers_hw_2strand_plain(peq_f, peq_r, text_t, lens, m=m)
    W, L, B, (pf, pr) = _check_launch({"peq_f": peq_f, "peq_r": peq_r},
                                      text_t, lens, m)
    G = _group(group, B, 2)
    dev = text_t.device
    lib = load_library()
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_hw_2strand(
            pf.data_ptr(), pr.data_ptr(), text_t.data_ptr(), lens.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), m, W, L, B, G, stream)
    _raise_on(rc, "cf_myers_hw_2strand")
    myers_hw_2strand.launches += 1
    return {"dist_f": out[0], "end_f": out[1],
            "dist_r": out[2], "end_r": out[3]}


myers_hw_2strand.launches = 0


def myers_hw_v3(peq, text_t, lens, *, m: int, group=None):
    """One-strand form of `myers_hw_2strand`: peq (5, W) int64 words,
    text_t (L, B) int8, lens (B,) or (B, 1) int32 -> {"dist", "end"},
    each (B,) int32. `group` as in `myers_hw_2strand`."""
    if text_t.device.type == "cpu":
        _group(group, text_t.shape[1], 1)
        return myers_hw_v3_plain(peq, text_t, lens, m=m)
    W, L, B, (pq,) = _check_launch({"peq": peq}, text_t, lens, m)
    G = _group(group, B, 1)
    dev = text_t.device
    lib = load_library()
    out = torch.empty((2, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_hw_1strand(
            pq.data_ptr(), text_t.data_ptr(), lens.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), m, W, L, B, G, stream)
    _raise_on(rc, "cf_myers_hw_1strand")
    myers_hw_v3.launches += 1
    return {"dist": out[0], "end": out[1]}


myers_hw_v3.launches = 0


class BandedRun:
    """One K3 call on the card (`csrc/myers_hw_banded.cu`), pass by pass.
    `myers_hw_v3_banded` runs `pass1()` then `pass2()`; chip_smoke.py times
    each alone. Each pass may run again on what the passes before it left:
    pass 1 starts from scratch, and pass 2 only lowers minima it already
    holds. Scratch and outputs come from torch.empty: the packed minima
    (B,) int64 ((dist << 32) | end, end as uint32), the survivor list (B,)
    and its count (1,) int32. The plan is `banded_plan`'s, pass 2's from
    the survivor count, the one value read back between the passes."""

    def __init__(self, peq, text_t, lens, *, m: int, k: int,
                 prefix_rows=None, window=None):
        self.W, self.L, self.B, (self.pq,) = _check_launch(
            {"peq": peq}, text_t, lens, m)
        self.text_t, self.lens, self.m, self.k = text_t, lens, m, min(k, m)
        self.prefix_rows, self.window = prefix_rows, window
        self.plan = banded_plan(m, self.k, self.L, self.B,
                                prefix_rows=prefix_rows, window=window)
        self.survivors = None       # pass 1's survivor count, once read
        dev = text_t.device
        self.out = torch.empty((2, self.B), dtype=torch.int32, device=dev)
        self.packed = torch.empty(self.B, dtype=torch.int64, device=dev)
        self.rows = torch.empty(self.B, dtype=torch.int32, device=dev)
        self.count = torch.empty(1, dtype=torch.int32, device=dev)

    def _launch(self, pass_no: int, p: BandedPass):
        dev = self.text_t.device
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.cf_myers_hw_banded(
                self.pq.data_ptr(), self.text_t.data_ptr(),
                self.lens.data_ptr(), self.out[0].data_ptr(),
                self.out[1].data_ptr(), self.packed.data_ptr(),
                self.rows.data_ptr(), self.count.data_ptr(), self.m, self.W,
                self.L, self.B, self.k, pass_no, p.q, p.S, p.overlap,
                p.windows, p.rows, pick_group(p.problems, 1), stream)
        _raise_on(rc, "cf_myers_hw_banded")

    def pass1(self):
        """Every row on the first r0 query rows: the survivors (prefix
        distance <= k) into the list, or, when r0 == m, the outputs."""
        self._launch(1, self.plan.pass1)

    def pass2(self):
        """The survivors on all m rows, then the outputs; nothing when
        pass 1 was exact."""
        if self.plan.pass2 is None:
            return
        if self.survivors is None:
            self.survivors = int(self.count.item())     # the one readback
            self.plan = banded_plan(
                self.m, self.k, self.L, self.B, survivors=self.survivors,
                prefix_rows=self.prefix_rows, window=self.window)
        self._launch(2, self.plan.pass2)

    def result(self) -> dict:
        return {"dist": self.out[0], "end": self.out[1]}


def myers_hw_v3_banded(peq, text_t, lens, *, m: int, k: int,
                       prefix_rows=None, window=None):
    """Threshold-k HW distances: `myers_hw_v3`'s (dist, end) where
    dist <= k, (m, -1) elsewhere. Same arguments, plus k >= 0. On the
    card a prefix pass drops the rows whose first r0 query rows already
    score above k, and an exact pass scores the rest in column windows
    (`banded_plan`; `prefix_rows` and `window` force r0 and S).
    Between the passes the survivor count is read back (4 bytes)."""
    if text_t.device.type == "cpu":
        L, B = text_t.shape                # checks k and the overrides
        banded_plan(m, min(k, m), L, B, prefix_rows=prefix_rows,
                    window=window)
        return myers_hw_v3_banded_plain(peq, text_t, lens, m=m, k=k)
    run = BandedRun(peq, text_t, lens, m=m, k=k, prefix_rows=prefix_rows,
                    window=window)
    run.pass1()
    run.pass2()
    myers_hw_v3_banded.launches += 1
    return run.result()


myers_hw_v3_banded.launches = 0


def recruit_distances(peq_fwd, peq_rc, codes, lens, *, m: int):
    """Two-strand recruitment distances of a (B, L) int8 code batch with
    (B,) int32 lens, on the batch's device -> (dist_f, dist_r) each (B,)."""
    out = myers_hw_2strand(peq_fwd, peq_rc, codes.t().contiguous(),
                           lens.contiguous(), m=m)
    return out["dist_f"], out["dist_r"]


PERROW_MAX_WORDS = 8    # K4: m <= 256, vp and vn in one thread's registers
PERROW_MAX_QUERIES = 256  # K4: a block holds 256 // Q whole windows
MODES = {"HW": 0, "SHW": 1}
# the decomposer's two calls: every later step (anchored start, each
# window's call: the query of least dist / m) and the first step (free
# start, the score after every column)
PERROW_CALLS = (("SHW", "call"), ("HW", "all"))


class PerrowQueries(NamedTuple):
    """K4's query set, checked and laid out once by `perrow_queries`, so
    that a step's call reads nothing back from the card and converts
    nothing."""
    peqs: torch.Tensor      # (Q, 5, W) int64-held 32-bit words
    words: torch.Tensor | None  # the same bits as int32 (the kernel's); CPU: None
    ms: torch.Tensor        # (Q,) int32 query lengths in [1, m]
    m: int


def perrow_queries(peqs, ms, *, m: int, device) -> PerrowQueries:
    """peqs: (Q, 5, W) int64 tensor of 32-bit words, W = n_words(m), each
    query's bits zero at and above its length; ms: (Q,) query lengths,
    each in [1, m] (checked here, on the host); Q >= 1. On the card
    m <= 256 and Q <= 256."""
    device = torch.device(device)
    ms_host = torch.as_tensor(ms).cpu()
    W = n_words(m)
    if m < 1 or (device.type == "cuda" and W > PERROW_MAX_WORDS):
        raise ValueError(f"m={m}: K4 takes 1 <= m <= "
                         f"{32 * PERROW_MAX_WORDS}")
    if peqs.dim() != 3 or tuple(peqs.shape[1:]) != (5, W) \
            or peqs.dtype != torch.int64:
        raise ValueError(f"peqs {peqs.dtype} {tuple(peqs.shape)}, "
                         f"expected int64 (Q, 5, {W})")
    Q = peqs.shape[0]
    if Q < 1 or (device.type == "cuda" and Q > PERROW_MAX_QUERIES):
        raise ValueError(f"{Q} queries: K4 takes 1 to "
                         f"{PERROW_MAX_QUERIES}")
    if ms_host.shape != (Q,):
        raise ValueError(f"ms shape {tuple(ms_host.shape)} for {Q} queries")
    if bool(((ms_host < 1) | (ms_host > m)).any()):
        raise ValueError(f"ms must lie in [1, {m}]")
    peqs = peqs.to(device).contiguous()
    return PerrowQueries(
        peqs, int32_words(peqs) if device.type == "cuda" else None,
        ms_host.to(device=device, dtype=torch.int32).contiguous(), m)


def _check_call(mode, collect, calls=PERROW_CALLS):
    if (mode, collect) not in calls:
        raise ValueError(f"mode={mode!r}, collect={collect!r}: K4 runs "
                         f"{calls}")


def _choose_calls(dist, end, ms) -> dict:
    """Each window's call from its rows: dist, end (R, Q) int32, ms (Q,)
    -> {"q", "dist", "end"} (R,) int32 of the query with the least
    dist / m, the first on ties: the quotients in float64, as the JAX
    decomposer's np.argmin(dist / ms) (with dist, m <= 256 two distinct
    quotients differ by at least 1/65,536 and two equal ones round
    alike, so K4's cross-multiplied comparison picks the same query)."""
    q = torch.argmin(dist.double() / ms.double(), dim=1, keepdim=True)
    return {"q": q[:, 0].to(torch.int32), "dist": dist.gather(1, q)[:, 0],
            "end": end.gather(1, q)[:, 0]}


def myers_perrow_plain(queries: PerrowQueries, windows, wlens, *,
                       mode="SHW", collect="call"):
    """Plain PyTorch version of K4: the rows of `myers_perrow` laid out
    (windows repeated Q times, the queries tiled R times) and scored by
    `myers_distance_batch`. Same arguments and outputs; besides
    PERROW_CALLS it gives SHW/best, every row's (dist, end) (R Q,), from
    which "call" chooses (`_choose_calls`)."""
    _check_call(mode, collect, PERROW_CALLS + (("SHW", "best"),))
    R, Q = windows.shape[0], queries.peqs.shape[0]
    out = myers_distance_batch(
        queries.peqs.repeat(R, 1, 1), windows.repeat_interleave(Q, dim=0),
        wlens.reshape(-1).repeat_interleave(Q), m=queries.m, mode=mode,
        ms=queries.ms.repeat(R), collect="best" if collect == "call"
        else collect)
    if collect != "call":
        return out
    return _choose_calls(out["dist"].reshape(R, Q),
                         out["end"].reshape(R, Q), queries.ms)


def myers_perrow(queries: PerrowQueries, windows, wlens, *, mode="SHW",
                 collect="call"):
    """Every window against every query: row r * Q + q is windows[r]
    (its first wlens[r] codes) against query q, the layout of
    `np.repeat(windows, Q)` beside `np.tile(peqs, R)`.

    queries: `perrow_queries(...)` on the windows' device; windows: (R, L)
    int8 codes; wlens: (R,) int32; (mode, collect) one of PERROW_CALLS:
    "call" -> {"q", "dist", "end"} (R,) int32, each window's query of least
    dist / m (the first on ties) and its row's SHW (dist, end); "all" ->
    {"scores"} (R Q, L) int32, as `ops/myers.myers_distance_batch`.
    On a CUDA tensor it launches K4 and synchronises nothing."""
    _check_call(mode, collect)
    dev = windows.device
    if dev.type == "cpu":
        return myers_perrow_plain(queries, windows, wlens, mode=mode,
                                  collect=collect)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if queries.words is None:
        raise ValueError("queries were laid out for the CPU")
    if windows.dim() != 2:
        raise ValueError(f"windows {tuple(windows.shape)} must be (R, L)")
    (R, L), (Q, _, W) = windows.shape, queries.words.shape
    _check("windows", windows, torch.int8, (R, L), dev)
    _check("queries", queries.words, torch.int32, (Q, 5, W), dev)
    _check("wlens", wlens, torch.int32, (R,), dev)
    lib = load_library()
    if collect == "all":
        scores = torch.empty((R * Q, L), dtype=torch.int32, device=dev)
        ptrs = (None, scores.data_ptr())
    else:
        call = torch.empty((3, R), dtype=torch.int32, device=dev)
        ptrs = (call.data_ptr(), None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_perrow(
            queries.words.data_ptr(), queries.ms.data_ptr(),
            windows.data_ptr(), wlens.data_ptr(), *ptrs, Q, R, L, W,
            MODES[mode], int(collect == "all"), stream)
    _raise_on(rc, "cf_myers_perrow")
    myers_perrow.launches += 1
    if collect == "all":
        return {"scores": scores}
    return {"q": call[0], "dist": call[1], "end": call[2]}


myers_perrow.launches = 0


CARRY_MODES = {"HW": 0, "SHW": 1, "NW": 1}    # 1: a 1 shifted into hp


def myers_carry(peq, text, lens, state: CarryState, c0: int, *, m: int,
                mode="HW", group=None) -> CarryState:
    """K5: the global columns [c0, c0 + C) of a (B, C) int8 `text` chunk
    (rows may be strided, columns contiguous) from `state`, on text's
    device -> the new state (fresh tensors). peq: (5, W) int64 words;
    lens: (B,) int32 global lengths; state on the same device. A column
    at or past a row's length leaves its state as it is. `group`: lanes a
    row, 8 or 32 (None: `pick_group(B, 1)`). For CPU tensors it runs
    `ops/myers.myers_carry_plain`; on a CUDA tensor it launches K5 and
    synchronises nothing."""
    if mode not in CARRY_MODES:
        raise ValueError(f"mode={mode!r}: one of {tuple(CARRY_MODES)}")
    if text.dim() != 2:
        raise ValueError(f"text must be (B, C), got {tuple(text.shape)}")
    B, C = text.shape
    group = _group(group, B, 1)
    dev = text.device
    if dev.type == "cpu":
        return myers_carry_plain(peq, text, lens, state, c0, m=m, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    W = n_words(m)
    if m < 1 or W > MAX_WORDS:
        raise ValueError(f"m={m}: K5 takes 1 <= m <= {32 * MAX_WORDS}")
    if text.dtype != torch.int8 or text.stride(1) != 1:
        raise ValueError(f"text must be (B, C) int8 with contiguous "
                         f"columns, got {text.dtype} {tuple(text.shape)} "
                         f"strides {text.stride()}")
    if c0 < 0:
        raise ValueError(f"c0={c0} < 0")
    _check("peq", peq, torch.int64, (5, W), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    for name in ("vp", "vn"):
        _check(name, getattr(state, name), torch.int32, (B, W), dev)
    sc_in = torch.stack(list(state[2:]))
    _check("score, best, end, final", sc_in, torch.int32, (4, B), dev)
    vp = torch.empty((B, W), dtype=torch.int32, device=dev)
    vn = torch.empty_like(vp)
    sc = torch.empty((4, B), dtype=torch.int32, device=dev)
    pq = int32_words(peq)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_carry(
            pq.data_ptr(), text.data_ptr(), lens.data_ptr(),
            state.vp.data_ptr(), state.vn.data_ptr(), sc_in.data_ptr(),
            vp.data_ptr(), vn.data_ptr(), sc.data_ptr(), m, W, C, B,
            max(text.stride(0), C), c0, CARRY_MODES[mode], group, stream)
    _raise_on(rc, "cf_myers_carry")
    myers_carry.launches += 1
    return CarryState(vp, vn, sc[0], sc[1], sc[2], sc[3])


myers_carry.launches = 0
