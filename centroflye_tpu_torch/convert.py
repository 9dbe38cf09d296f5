"""Carry the JAX recruitment engine's tables into the port.

The recruitment engine's "weights" are its query tables: the unit's peq
bit tables for both strands and, with the prefilter, the sorted seed
table and the seed bitmaps (big- and little-endian keyed). Given them as
numpy arrays, under the JAX engine's attribute names, this module turns
them into the port's tensors on a device, for
`RecruitmentEngine.from_state`.
"""

from __future__ import annotations

import numpy as np

from centroflye_tpu_torch.ops.myers import words_tensor

# JAX RecruitmentEngine attribute -> port state key
RECRUITMENT_STATE_KEYS = {"peq_fwd": "peq_fwd", "peq_rc": "peq_rc",
                          "_seed_hi": "seed_hi", "_seed_lo": "seed_lo",
                          "_seed_bitmap": "bitmap",
                          "_bitmap_le": "bitmap_le"}


def recruitment_state_from_numpy(d: dict, device="cpu") -> dict:
    """{"peq_fwd", "peq_rc": (5, W) uint32; "_seed_hi", "_seed_lo": (n,)
    uint32; "_seed_bitmap", "_bitmap_le": (4^k/32,) uint32} numpy arrays
    -> the port's state keys (RECRUITMENT_STATE_KEYS), int64 tensors of
    32-bit words on `device`. The seed tables are absent when the engine
    runs without the prefilter. Other keys are ignored."""
    state = {}
    for src, dst in RECRUITMENT_STATE_KEYS.items():
        if src not in d:
            continue
        arr = np.asarray(d[src])
        if arr.dtype != np.uint32:
            raise TypeError(f"{src}: dtype {arr.dtype}, expected uint32")
        state[dst] = words_tensor(arr, device)
    return state
