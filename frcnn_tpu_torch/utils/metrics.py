"""Metrics logging, step timing and profiling (the JAX package's
``utils/metrics.py``).

* :class:`MetricsLogger` — a JSONL stream of per-step scalars (the four
  loss series, counts, wall time) for tooling;
* :class:`StepTimer` — wall clock per step with an exponential moving
  average (the ``torch.Timer`` the reference allocates but never reports,
  ``main.lua:132,137``);
* :func:`profiler_trace` — ``torch.profiler`` around a block, written as a
  Chrome trace;
* :func:`sync` and :func:`loop_time` — the device clock of the bench and
  the stage profilers.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` (CPU, and CUDA where there is a card) around a
    block, written to ``<log_dir>/trace.json`` as a Chrome trace (view in
    Perfetto or chrome://tracing); a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def seconds(fn, k: int, device) -> float:
    """Seconds of ``k`` calls of ``fn`` back to back: CUDA events on the
    card (one synchronize at the end), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    for _ in range(k):
        fn()
    return time.perf_counter() - t


def differenced_seconds(fn, n: int, device):
    """(seconds per call of ``fn``, seconds of the shorter run): a first
    call (kernel build, allocations), then the best of 3 trials at
    ``1 + n // 4`` and at ``1 + n`` calls, differenced (the JAX scripts'
    two loop lengths)."""
    fn()
    sync(device)

    def timed(k, trials=3):
        return min(seconds(fn, k, device) for _ in range(trials))

    t_small = timed(1 + n // 4)
    t_big = timed(1 + n)
    return (t_big - t_small) / (n - n // 4), t_small


def loop_time(fn, n: int, label: str, device, out=print) -> float:
    """Seconds per call of ``fn`` (``scripts/profile_detect.py:51-74``),
    by :func:`differenced_seconds`."""
    per, t_small = differenced_seconds(fn, n, device)
    out(f"{label:18s} {per * 1e3:9.3f} ms/iter   (n={n}, base "
        f"{t_small * 1e3:.0f} ms)")
    return per
