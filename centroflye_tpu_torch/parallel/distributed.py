"""Multi-process execution glue, the JAX package's `parallel/distributed.py`
on `torch.distributed`.

The reference has no multi-node anything (SURVEY §2.2); the engine scales
by data parallelism over reads. In a multi-process run:

- every process calls `init_distributed()` (a gloo process group: its
  address, world size and rank given, or read from the MASTER_ADDR /
  MASTER_PORT / RANK / WORLD_SIZE environment) and streams its own share
  of the read files or of one shared read stream (`shard_read_files`,
  `shard_read_stream`: round robin, so processes need no coordination);
- recruitment needs no collective: each process writes a partial FASTA
  with the reads' global ordinals, marks it done, and process 0
  (`is_coordinator`) merges the parts in global input order
  (`merge_partial_fastas`), so the merged file is byte for byte the
  single-process one.

Without a process group everything is the single process's.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a gloo process group; returns True when more than one process
    takes part. coordinator_address is an init method such as
    "tcp://localhost:29500" or "file:///shared/dir/store" (then
    num_processes and process_id are needed too). Without it, the group
    is read from the environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE) when MASTER_ADDR is set; otherwise nothing is joined."""
    if not _active():
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed: an address needs "
                                 "num_processes and process_id")
            dist.init_process_group("gloo", init_method=coordinator_address,
                                    world_size=num_processes,
                                    rank=process_id)
        elif "MASTER_ADDR" in os.environ:
            dist.init_process_group("gloo", init_method="env://")
    return process_count() > 1


def is_coordinator() -> bool:
    return process_index() == 0


def shard_read_files(files: List[str]) -> List[str]:
    """Round-robin assignment of input files to this process."""
    return [f for i, f in enumerate(files)
            if i % process_count() == process_index()]


def shard_read_stream(reads: Iterable[Tuple[str, str]]
                      ) -> Iterator[Tuple[int, Tuple[str, str]]]:
    """Round-robin assignment of reads within one stream (one shared
    input file). Yields (global_ordinal, (r_id, seq)) so the per-process
    outputs merge back in exact global input order."""
    p, n = process_index(), process_count()
    for i, item in enumerate(reads):
        if i % n == p:
            yield i, item


def partial_path(output_fn: str, process: Optional[int] = None) -> str:
    p = process_index() if process is None else process
    return f"{output_fn}.part{p}"


def finish_partial(output_fn: str) -> None:
    """Mark this process's partial artifact complete (the shared
    filesystem's token that the coordinator's merge waits on)."""
    with open(partial_path(output_fn) + ".done", "w") as f:
        f.write("done\n")


def merge_partial_fastas(output_fn: str, timeout_s: float = 3600.0,
                         poll_s: float = 0.5) -> int:
    """Coordinator-side merge of every process's partial FASTA into
    `output_fn` in exact global input order. A part's records are
    `>ordinal r_id` / sequence (the distributed recruit path writes them).
    Waits for every process's .done token, raising TimeoutError after
    `timeout_s`, then writes the records sorted by ordinal without the
    ordinals and removes the parts. Returns the merged record count: the
    same count and file as a single-process run."""
    from centroflye_tpu_torch.io.fasta import atomic_write

    n = process_count()
    deadline = time.monotonic() + timeout_s
    parts = [partial_path(output_fn, p) for p in range(n)]
    while any(not os.path.exists(p + ".done") for p in parts):
        if time.monotonic() > deadline:
            missing = [p for p in parts if not os.path.exists(p + ".done")]
            raise TimeoutError(f"partial artifacts never finished: {missing}")
        time.sleep(poll_s)

    records = []
    for part in parts:
        with open(part) as f:
            header = None
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    header = line[1:]
                elif header is not None:
                    ordinal, _, r_id = header.partition(" ")
                    records.append((int(ordinal), r_id, line))
                    header = None
    records.sort()
    with atomic_write(output_fn) as out:
        for _, r_id, seq in records:
            out.write(f">{r_id}\n{seq}\n")
    for part in parts:
        os.remove(part)
        os.remove(part + ".done")
    return len(records)
