"""Structured logging / metric history.

A copy of ``gpmdm_tpu/utils/logging.py``: a lightweight metric logger that
accumulates named scalar series (loss, steps/s, frame accuracy, fps, ...)
and emits machine-readable JSON lines, without a logging framework.
``train.trainer.train_adam`` and ``utils.metrics.evaluate_pf`` /
``evaluate_pf_banked`` write to it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional


class MetricLogger:
    """Accumulates named scalar series and optionally streams JSON lines.

    >>> log = MetricLogger(stream=None)
    >>> log.log(step=0, loss=12.5)
    >>> log.history["loss"]
    [(0, 12.5)]
    """

    def __init__(self, stream=sys.stderr, jsonl_path: Optional[str] = None):
        self.history: Dict[str, List[tuple]] = {}
        self._stream = stream
        self._jsonl_path = Path(jsonl_path) if jsonl_path else None
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics: float) -> None:
        record = {"step": int(step), "t": round(time.perf_counter() - self._t0, 4)}
        for name, value in metrics.items():
            value = float(value)
            record[name] = value
            self.history.setdefault(name, []).append((int(step), value))
        line = json.dumps(record)
        if self._stream is not None:
            print(line, file=self._stream)
        if self._jsonl_path is not None:
            with self._jsonl_path.open("a") as f:
                f.write(line + "\n")

    def series(self, name: str):
        """(steps, values) arrays for one metric."""
        import numpy as np

        pairs = self.history.get(name, [])
        if not pairs:
            return np.zeros(0, dtype=int), np.zeros(0)
        steps, values = zip(*pairs)
        return np.asarray(steps), np.asarray(values)

    def last(self, name: str) -> Optional[float]:
        pairs = self.history.get(name)
        return pairs[-1][1] if pairs else None

    def summary(self) -> str:
        lines = []
        for name, pairs in self.history.items():
            lines.append(f"{name}: {len(pairs)} points, last {pairs[-1][1]:.6g}")
        return "\n".join(lines)
