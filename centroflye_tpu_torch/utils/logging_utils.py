"""Stage timing and the run's `metrics.json`: the JAX package's
`utils/logging_utils.py` less `jax_profile` (the JAX profiler; nothing
on the pipeline's path calls it).

Every pipeline stage runs under `MetricsRegistry.stage`, which records
wall-clock seconds, an item count and their rate, and rewrites
`metrics.json` in the run's output directory with the same keys as the
JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("centroflye_tpu_torch")


@dataclasses.dataclass
class StageMetrics:
    name: str
    wall_s: float = 0.0
    items: int = 0
    unit: str = "items"

    @property
    def rate(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0


class MetricsRegistry:
    """Per-run metrics sink; write() persists a JSON artifact."""

    def __init__(self, outdir: Optional[str] = None):
        self.outdir = outdir
        self.stages: Dict[str, StageMetrics] = {}

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        m = self.stages.setdefault(name, StageMetrics(name=name, unit=unit))
        logger.info("stage %s: start", name)
        t0 = time.perf_counter()
        try:
            yield m
        finally:
            m.wall_s += time.perf_counter() - t0
            logger.info("stage %s: done in %.2fs (%d %s, %.1f %s/s)",
                        name, m.wall_s, m.items, m.unit, m.rate, m.unit)
            self.write()

    def write(self):
        if not self.outdir:
            return
        os.makedirs(self.outdir, exist_ok=True)
        payload = {
            name: {"wall_s": m.wall_s, "items": m.items, "unit": m.unit,
                   "rate": m.rate}
            for name, m in self.stages.items()
        }
        with open(os.path.join(self.outdir, "metrics.json"), "w") as f:
            json.dump(payload, f, indent=2)
