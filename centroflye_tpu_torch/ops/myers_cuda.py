"""HW Myers on the card: the counterpart of the JAX package's
`ops/myers_pallas_v3.py`.

| wrapper | CUDA source | replaces |
|---|---|---|
| `myers_hw_2strand` (and `recruit_distances`) | `csrc/myers_hw_2strand.cu` | `myers_hw_pallas_v3_2strand`, `recruit_distances_pallas` |
| `myers_hw_v3` | `csrc/myers_hw_2strand.cu` (one strand) | `myers_hw_pallas_v3` |
| `myers_hw_v3_banded` | `csrc/myers_hw_banded.cu` | `myers_hw_pallas_v3_banded` |

Each wrapper launches its kernel for CUDA tensors and counts the launch
in its `launches` attribute. The two-strand and one-strand wrappers run
one kernel template in instances of G = 8 or 32 lanes per
(row, strand): `pick_group` chooses G from the batch, and the keyword
`group` forces one. For CPU tensors it runs its plain PyTorch
version (`*_plain`, built on `ops/myers.myers_distance_batch`), which is
also what the kernel is compared with on the card. Nothing falls back: on
a CUDA tensor a wrapper launches its kernel or raises.
"""

from __future__ import annotations

import torch

from centroflye_tpu_torch.ops._build import load_library
from centroflye_tpu_torch.ops.myers import MASK, myers_distance_batch, n_words

MAX_WORDS = 4 * 32      # m <= 4096
GROUPS = (8, 32)        # lanes per (row, strand) of myers_hw_2strand.cu
SMALL_BATCH = 512       # (row, strand) problems at or below which G = 32


def pick_group(B: int, strands: int) -> int:
    """Lanes per (row, strand) for a batch of B rows. Up to SMALL_BATCH
    problems, G = 32 gives each problem a warp and each warp its own
    scheduler (the H100 has 528), and the time is one warp's chain of
    dependent steps, which 32 lanes make the shortest. Above it the warps
    share schedulers and integer issue sets the time: G = 8 has the fewest
    idle word slots and the least fixed work per word. Measured at 128 and
    2048 rows on DXZ1 only (W = 65 words, PERF.md): a short query with few
    words leaves most of a 32-lane group idle, so a caller at another m
    should measure before relying on the rule."""
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


def myers_hw_2strand_plain(peq_f, peq_r, text_t, lens, *, m: int):
    """Plain PyTorch version of the two-strand kernel: same arguments and
    outputs."""
    out_f = myers_hw_v3_plain(peq_f, text_t, lens, m=m)
    out_r = myers_hw_v3_plain(peq_r, text_t, lens, m=m)
    return {"dist_f": out_f["dist"], "end_f": out_f["end"],
            "dist_r": out_r["dist"], "end_r": out_r["end"]}


def _words_as_int32(peq: torch.Tensor) -> torch.Tensor:
    """int64-held 32-bit words -> int32 tensor with the same bits."""
    return torch.where(peq > 0x7FFFFFFF, peq - (MASK + 1), peq).to(
        torch.int32).contiguous()


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
    return W, L, B, [_words_as_int32(p) for p in peqs.values()]


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


def myers_hw_v3_banded(peq, text_t, lens, *, m: int, k: int):
    """Threshold-k HW distances: `myers_hw_v3`'s (dist, end) where
    dist <= k, (m, -1) elsewhere. Same arguments, plus k >= 0. On the
    card only the query rows inside an Ukkonen band are computed
    (`csrc/myers_hw_banded.cu`)."""
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if text_t.device.type == "cpu":
        return myers_hw_v3_banded_plain(peq, text_t, lens, m=m, k=k)
    W, L, B, (pq,) = _check_launch({"peq": peq}, text_t, lens, m)
    dev = text_t.device
    lib = load_library()
    out = torch.empty((2, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_hw_banded(
            pq.data_ptr(), text_t.data_ptr(), lens.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), m, W, L, B, min(k, m),
            stream)
    _raise_on(rc, "cf_myers_hw_banded")
    myers_hw_v3_banded.launches += 1
    return {"dist": out[0], "end": out[1]}


myers_hw_v3_banded.launches = 0


def recruit_distances(peq_fwd, peq_rc, codes, lens, *, m: int):
    """Two-strand recruitment distances of a (B, L) int8 code batch with
    (B,) int32 lens, on the batch's device -> (dist_f, dist_r) each (B,)."""
    out = myers_hw_2strand(peq_fwd, peq_rc, codes.t().contiguous(),
                           lens.contiguous(), m=m)
    return out["dist_f"], out["dist_r"]
