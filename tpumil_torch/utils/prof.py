"""Profiling and observability (counterpart of tpumil/utils/prof.py).

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (host
    and, on a card, CUDA activity) that writes a Chrome trace into
    ``logdir``;
  * ``ThroughputMeter``: windowed items/sec counters (patches/sec, ...);
  * ``ScalarLogger``: a JSONL scalar stream, with TensorBoard event files
    when ``torch.utils.tensorboard`` imports (the role of the reference's
    SummaryWriter, simclr/simclr.py:36,104-105).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque

import torch

TRACE_FILE = "trace.json"
WINDOW = 50  # ThroughputMeter's window, in add() calls


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write ``logdir/trace.json`` (open it in Perfetto
    or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class ThroughputMeter:
    """Windowed throughput counter."""

    def __init__(self, unit: str = "items"):
        self.unit = unit
        self._events = deque(maxlen=WINDOW)
        self.total = 0
        self._t0 = time.perf_counter()

    def add(self, n: int) -> None:
        self._events.append((time.perf_counter(), n))
        self.total += n

    @property
    def rate(self) -> float:
        """items/sec over the window."""
        if len(self._events) < 2:
            return 0.0
        t_first = self._events[0][0]
        t_last = self._events[-1][0]
        n = sum(c for _, c in list(self._events)[1:])
        return n / max(t_last - t_first, 1e-9)

    @property
    def mean_rate(self) -> float:
        return self.total / max(time.perf_counter() - self._t0, 1e-9)

    def __str__(self) -> str:
        return f"{self.rate:.1f} {self.unit}/s (mean {self.mean_rate:.1f})"


def _summary_writer(logdir: str):
    """A TensorBoard ``SummaryWriter`` on ``logdir``, or None where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


class ScalarLogger:
    """Scalars to ``scalars.jsonl`` (always) and TensorBoard events (when
    ``torch.utils.tensorboard`` imports)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = _summary_writer(logdir)

    def log(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
