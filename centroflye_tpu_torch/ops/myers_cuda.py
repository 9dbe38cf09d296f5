"""Two-strand HW Myers on the card: the counterpart of
the JAX package's `ops/myers_pallas_v3.py` (`myers_hw_pallas_v3_2strand`
and `recruit_distances_pallas`).

`myers_hw_2strand` launches the CUDA kernel of
`csrc/myers_hw_2strand.cu` for CUDA tensors. For CPU tensors it runs
`myers_hw_2strand_plain`, the plain PyTorch version of the same function
(two calls of `ops/myers.myers_distance_batch`), which is also what the
kernel is compared with on the card.
"""

from __future__ import annotations

import torch

from centroflye_tpu_torch.ops._build import load_library
from centroflye_tpu_torch.ops.myers import MASK, myers_distance_batch, n_words

MAX_WORDS = 4 * 32      # the kernel's widest instance: 4 words per lane


def myers_hw_2strand_plain(peq_f, peq_r, text_t, lens, *, m: int):
    """Plain PyTorch version of the kernel: same arguments and outputs."""
    text = text_t.t()
    lens = lens.reshape(-1)
    out_f = myers_distance_batch(peq_f, text, lens, m=m, mode="HW")
    out_r = myers_distance_batch(peq_r, text, lens, m=m, mode="HW")
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


def myers_hw_2strand(peq_f, peq_r, text_t, lens, *, m: int):
    """HW edit distance of the unit (peq_f) and of its reverse complement
    (peq_r) against each text column of text_t, plus the first column
    that reaches each minimum.

    peq_f, peq_r: (5, W) int64 tensors of 32-bit words (ops/myers.words_tensor);
    text_t: (L, B) int8 codes, 0-3 bases, >= 4 N/PAD; lens: (B,) or (B, 1)
    int32. Columns at or past lens do not move the score. Returns
    {"dist_f", "end_f", "dist_r", "end_r"}, each (B,) int32.
    """
    dev = text_t.device
    if dev.type == "cpu":
        return myers_hw_2strand_plain(peq_f, peq_r, text_t, lens, m=m)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    W = n_words(m)
    if W > MAX_WORDS:
        raise ValueError(f"m={m} needs {W} words; the kernel takes at most "
                         f"{MAX_WORDS} (m <= {32 * MAX_WORDS})")
    if text_t.dim() != 2:
        raise ValueError(f"text_t must be (L, B), got {tuple(text_t.shape)}")
    L, B = text_t.shape
    _check("text_t", text_t, torch.int8, (L, B), dev)
    _check("peq_f", peq_f, torch.int64, (5, W), dev)
    _check("peq_r", peq_r, torch.int64, (5, W), dev)
    _check("lens", lens, torch.int32, tuple(lens.shape), dev)
    if lens.numel() != B or lens.dim() not in (1, 2):
        raise ValueError(f"lens shape {tuple(lens.shape)} for B={B}")
    lib = load_library()
    pf, pr = _words_as_int32(peq_f), _words_as_int32(peq_r)
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cf_myers_hw_2strand(
            pf.data_ptr(), pr.data_ptr(), text_t.data_ptr(), lens.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), m, W, L, B, stream)
    if rc != 0:
        raise RuntimeError(f"cf_myers_hw_2strand launch failed: CUDA error "
                           f"{rc}")
    myers_hw_2strand.launches += 1
    return {"dist_f": out[0], "end_f": out[1],
            "dist_r": out[2], "end_r": out[3]}


myers_hw_2strand.launches = 0


def recruit_distances(peq_fwd, peq_rc, codes, lens, *, m: int):
    """Two-strand recruitment distances of a (B, L) int8 code batch with
    (B,) int32 lens, on the batch's device -> (dist_f, dist_r) each (B,)."""
    out = myers_hw_2strand(peq_fwd, peq_rc, codes.t().contiguous(),
                           lens.contiguous(), m=m)
    return out["dist_f"], out["dist_r"]
