"""Profiling and observability (counterpart of tpumil/utils/prof.py).

  * ``span(name)``: the program's own spans, recorded in memory while
    ``recording()`` is on and read back by ``collect()``; stamped on the
    profiler's clock (Unix-epoch ns), so that a span and a profiler event
    of the same moment carry the same number and the spans can be laid
    over a device trace taken with CUDA activity alone;
  * ``trace(logdir)``: a context manager around ``torch.profiler`` (host
    and, on a card, CUDA activity) that records spans too and writes both
    into a Chrome trace in ``logdir``;
  * ``ThroughputMeter``: windowed items/sec counters (patches/sec, ...);
  * ``ScalarLogger``: a JSONL scalar stream, with TensorBoard event files
    when ``torch.utils.tensorboard`` imports (the role of the reference's
    SummaryWriter, simclr/simclr.py:36,104-105).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import List, NamedTuple

import torch

TRACE_FILE = "trace.json"
WINDOW = 50  # ThroughputMeter's window, in add() calls


# -- spans ---------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span: ``parent`` is the id of the innermost span open
    on the same thread when it began (0: none); ``tid`` the thread's native
    id; times in Unix-epoch ns."""

    name: str
    id: int
    parent: int
    tid: int
    start_ns: int
    end_ns: int


class _NoSpan:
    """What ``span`` returns while the recorder is off: no clock read, no
    record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_on = False
_offset_ns = 0          # Unix-epoch ns less perf_counter_ns, read at switch-on
_records: list = []     # Span fields as plain tuples, in order of ending
_ids = itertools.count(1)
# per thread: .stack, the ids of its open spans, and .tid, its native id,
# read once: a system call, which took ~7 µs on an H100 machine's host
_open = threading.local()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "stack", "tid")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            self.stack, self.tid = _open.stack, _open.tid
        except AttributeError:
            self.stack = _open.stack = []
            self.tid = _open.tid = threading.get_native_id()
        self.parent = self.stack[-1] if self.stack else 0
        self.id = next(_ids)
        self.stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        _records.append((self.name, self.id, self.parent, self.tid,
                         self.start + _offset_ns, end + _offset_ns))
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while the
    recorder is on; while it is off, one shared object that does
    nothing."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record spans for the life of the block (off is the default); the
    previous state is restored after it."""
    global _on, _offset_ns
    was = _on
    if not was:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
        _on = True
    try:
        yield
    finally:
        _on = was


def collect() -> List[Span]:
    """The spans ended since the last call, in order of ending; clears
    them."""
    global _records
    out, _records = _records, []
    return [Span(*r) for r in out]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and record its spans; write ``logdir/trace.json``
    (open it in Perfetto or chrome://tracing), the spans as complete
    events of category ``span`` on their threads beside the profiler's.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, recording():
        yield prof
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))  # ts are µs after it
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": os.getpid(),
         "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent}} for s in collect())
    with open(path, "w") as f:
        json.dump(doc, f)


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
