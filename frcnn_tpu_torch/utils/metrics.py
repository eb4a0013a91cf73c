"""Metrics logging and step timing (the JAX package's ``utils/metrics.py``).

* :class:`MetricsLogger` — a JSONL stream of per-step scalars (the four
  loss series, counts, wall time) for tooling;
* :class:`StepTimer` — wall clock per step with an exponential moving
  average (the ``torch.Timer`` the reference allocates but never reports,
  ``main.lua:132,137``).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def log(self, step: int, metrics: Dict[str, float], **extra):
        if self._f is None:
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               **extra}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class StepTimer:
    """Wall-clock per-step timer with an exponential moving average."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            (1 - self.alpha) * self.ema + self.alpha * dt)
        return dt
