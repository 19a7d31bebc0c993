"""Wall-clock timing with the reference's bucket vocabulary.

The reference brackets CUDA regions with stream-sync fences
(``AdaQP/util/timer.py:18-27``) and buckets names into
``[comm, quant, central, marginal, full]`` (``timer.py:29-51``). The port
keeps the same vocabulary:

- per-epoch totals are wall-clock around a step that ends in a host
  readback of the loss (which waits for the device);
- the breakdown buckets hold the sub-computation timings added under
  their names (``Trainer._breakdown_probe``). The CSV layout stays
  reference-compatible (``trainer.py:226-234``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class Timer:
    BUCKETS = ("communication", "quantization", "central", "marginal", "full")

    def __init__(self):
        self._records: Dict[str, List[float]] = defaultdict(list)
        self.epoch_times: List[float] = []

    @contextmanager
    def record(self, name: str):
        t0 = time.perf_counter()
        yield
        self._records[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self._records[name].append(seconds)

    def add_epoch(self, seconds: float):
        self.epoch_times.append(seconds)

    def epoch_traced_time(self) -> List[float]:
        """[comm, quant, central, marginal, full] bucket sums (reference
        ``timer.py:29-51``): any record whose name contains the bucket
        keyword counts toward it."""
        out = []
        for bucket in self.BUCKETS:
            total = 0.0
            for name, vals in self._records.items():
                if bucket in name:
                    total += sum(vals)
            out.append(total)
        return out

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self._records.items()}

    def clear(self):
        self._records.clear()
        self.epoch_times.clear()

    def persist(self, path: str):
        """Dump raw records (reference: ``Timer.persist``, timer.py:59-66)."""
        import json
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"records": dict(self._records), "epoch_times": self.epoch_times},
                f,
                indent=1,
            )
