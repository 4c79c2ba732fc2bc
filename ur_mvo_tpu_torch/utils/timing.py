"""Per-stage wall-clock instrumentation.

``StageTimer`` of ``ur_mvo_tpu.utils.timing``: named stages accumulate
count/total/min/max and export a summary dict or CSV. These are host
times: CUDA work is asynchronous, so a span holds device time only where
it ends in a readback or a ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import csv
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self) -> None:
        self._stats: Dict[str, list] = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self._stats[name]
            s[0] += 1
            s[1] += dt
            s[2] = min(s[2], dt)
            s[3] = max(s[3], dt)

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "count": s[0],
                "total_s": s[1],
                "mean_ms": 1e3 * s[1] / max(1, s[0]),
                "min_ms": 1e3 * s[2] if s[0] else 0.0,
                "max_ms": 1e3 * s[3],
            }
            for name, s in self._stats.items()
        }

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["stage", "count", "total_s", "mean_ms", "min_ms", "max_ms"])
            for name, d in self.summary().items():
                w.writerow([name, d["count"], f"{d['total_s']:.6f}", f"{d['mean_ms']:.3f}", f"{d['min_ms']:.3f}", f"{d['max_ms']:.3f}"])

    def reset(self) -> None:
        self._stats.clear()
