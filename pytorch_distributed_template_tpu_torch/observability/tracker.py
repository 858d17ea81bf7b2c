"""Running-average metric tracking (a copy of the JAX package's
``observability/tracker.py``): per-key total/count/average over a plain
dict, with an optional TensorBoard write on every update.
"""
from __future__ import annotations


class MetricTracker:
    def __init__(self, *keys, writer=None):
        self.writer = writer
        self._data = {k: [0.0, 0, 0.0] for k in keys}  # total, count, average

    def reset(self) -> None:
        for k in self._data:
            self._data[k] = [0.0, 0, 0.0]

    def update(self, key, value, n: int = 1) -> None:
        if key not in self._data:
            self._data[key] = [0.0, 0, 0.0]
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        total, count, _ = self._data[key]
        total += float(value) * n
        count += n
        self._data[key] = [total, count, total / count]

    def avg(self, key) -> float:
        return self._data[key][2]

    def count(self, key) -> int:
        return self._data[key][1]

    def result(self) -> dict:
        return {k: v[2] for k, v in self._data.items()}

    def keys(self):
        return list(self._data)
