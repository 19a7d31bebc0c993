"""Metric recorder (reference: ``AdaQP/util/recorder.py``): an
``epochs x 3`` train/val/test matrix with best-epoch-by-val selection."""
from __future__ import annotations

from typing import Tuple

import numpy as np


class Recorder:
    def __init__(self, num_epochs: int):
        self.metrics = np.zeros((num_epochs, 3), np.float64)
        self._cursor = 0

    def add(self, train: float, val: float, test: float):
        self.metrics[self._cursor] = (train, val, test)
        self._cursor += 1

    @property
    def num_recorded(self) -> int:
        return self._cursor

    def best(self) -> Tuple[int, float, float, float]:
        """(best_epoch, train, val, test) at the best-validation epoch
        (reference ``recorder.py:19-39``)."""
        m = self.metrics[: self._cursor]
        if not len(m):
            return 0, 0.0, 0.0, 0.0
        e = int(np.argmax(m[:, 1]))
        return e, float(m[e, 0]), float(m[e, 1]), float(m[e, 2])

    def val_curve(self) -> np.ndarray:
        return self.metrics[: self._cursor, 1].copy()
