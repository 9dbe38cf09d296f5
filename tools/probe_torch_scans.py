"""Card time of the scans in the distance sweep's device work
(`centroflye_tpu_torch/stages/distance_graph.py`), as written and as the
JAX package's scans translate literally.

    python3 tools/probe_torch_scans.py [--n N]

At N elements (default 63 << 20, the sweep's raw-strip chunk), one JSON
line each, with CUDA-event milliseconds of one call and a check that both
forms give the same values:
- fill: `_fill_by_boundaries` over 3 columns (one 1-D cumsum each)
  against one cumsum along dim 0 of an (N, 3) grid;
- right / left: `_nearest_right` and `_nearest_left` (a cumsum, a
  scatter and a gather) against `torch.cummin` of the flipped array and
  `torch.cummax`, on sorted keys with a run boundary every 4 elements.
Needs a card.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from centroflye_tpu_torch.stages.distance_graph import (  # noqa: E402
    _FAR, _fill_by_boundaries, _nearest_left, _nearest_right)


def timed(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def grid_fill(cols, bpos, size):
    """The literal translation: one (size + 1, C) grid, one cumsum along
    dim 0."""
    vals = torch.stack(cols, dim=1)
    grid = torch.zeros((size + 1, vals.shape[1]), dtype=torch.int64,
                       device=vals.device)
    grid[0] += vals[0]
    grid.index_add_(0, bpos.clamp(max=size), vals[1:] - vals[:-1])
    return torch.cumsum(grid[:size], dim=0).unbind(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=63 << 20)
    n = ap.parse_args().n
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # entries of about 64 slots each, as the sub-bucket fill has
    n_e = max(2, n // 64)
    bpos = torch.sort(torch.randint(0, n, (n_e - 1,), generator=g,
                                    device=dev)).values
    cols = [torch.randint(0, 1 << 30, (n_e,), generator=g, device=dev)
            for _ in range(3)]
    iota = torch.arange(n, device=dev)
    mark = iota % 4 == 3
    for name, new, old in (
            ("fill", lambda: _fill_by_boundaries(cols, bpos, n),
             lambda: grid_fill(cols, bpos, n)),
            ("right", lambda: [_nearest_right(mark, iota, _FAR)],
             lambda: [torch.cummin(torch.where(mark, iota, _FAR).flip(0),
                                   dim=0).values.flip(0)]),
            ("left", lambda: [_nearest_left(mark, iota, 0)],
             lambda: [torch.cummax(torch.where(mark, iota, 0),
                                   dim=0).values])):
        new()                                     # warm-up
        got, ms = timed(new)
        want, old_ms = timed(old)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(json.dumps({"probe": name, "n": n, "ms": ms,
                          "scan_ms": old_ms, "equal": same}), flush=True)
        if not same:
            raise SystemExit(f"probe: {name} differs")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
