"""The program's spans (``tpumil_torch.utils.prof.span``) laid over a
traced window: each device operation put down to the innermost span open
when its launch call began, and each idle gap to the innermost span open
at its middle.

``SpanTrace`` is ``harness.Trace`` with three more fields, empty by
default: the window's spans, and the CUPTI correlation id of each device
event and of each host event. A kernel carries the id of the runtime call
that launched it (kineto's ``correlation_id()``; ``linked_correlation_id()``
is 0 on both, as read on an H100 with torch 2.11). Kineto numbers the
runtime calls' threads by its own count, not by the native id a span
carries, so the spans of the program's thread are those of the thread
that recorded the most.

    python3 -m portbench.spans --workload <cell> --seed <n> \
        --seconds <s> [--recorder 0|1]

runs a cell's set-up and window as ``portbench.run`` does, with the
window under the profiler (CUDA activity alone) and the span recorder on
(``--recorder 0``: off, to price it), and prints one JSON line: the cell's
per-layer metrics, those that read spans among them, the breakdown with
``idle_spans``, and how much of the device's work and launches the spans
cover. It decides no ``correct``: that is ``portbench.run``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

OUTSIDE = "outside program spans"
NO_LAUNCH = "launch call not traced"
# the metrics that read spans, by cell: the per-layer entries the
# benchmark gains once its traced runs record spans (PERF.md, section 7)
SPAN_METRICS = {
    "tcga-train": ("host_ms_per_step.train",
                   "optim_device_ms_per_step.train"),
    "simclr-b4096": ("augment_device_pct.simclr",),
}


def innermost(spans: Sequence[tuple], times: Sequence[float]
              ) -> List[Optional[int]]:
    """For each time, the index in ``spans`` of the innermost span open at
    it (start <= t < end), or None; ``spans`` nested as one thread's are,
    sorted by (start, -end)."""
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][4] <= t:
            while stack and spans[stack[-1]][5] <= spans[i][4]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][5] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


@dataclasses.dataclass
class SpanTrace(harness.Trace):
    """A traced window with its spans ``(name, id, parent, tid, start,
    end)`` (µs on the profiler's clock) and the correlation id of each
    device event and each host event (0: none), in the order of
    ``device`` and ``host``."""

    spans: List[tuple] = dataclasses.field(default_factory=list)
    device_corr: List[int] = dataclasses.field(default_factory=list)
    host_corr: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof, window_s: float, devices: int,
                      spans: Sequence = ()) -> "SpanTrace":
        """As ``harness.Trace.from_profiler``, with the correlation ids,
        and ``spans`` (``prof.Span``s, ns) in µs."""
        dev, host_by_tid = [], {}
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            name = e.name()
            corr = int(e.correlation_id())
            if str(e.device_type()).endswith("CUDA"):
                if not harness._is_annotation(e):
                    dev.append(((name, start, end, harness._device_kind(name),
                                 int(e.device_index())), corr))
            else:
                kind = "cuda_runtime" if name.startswith("cuda") else "host"
                host_by_tid.setdefault(e.start_thread_id(), []).append(
                    ((name, start, end, kind), corr))
        host = max(host_by_tid.values(), default=[],
                   key=lambda evs: sum(ev[0][3] == "cuda_runtime"
                                       for ev, _ in evs))
        dev.sort(key=lambda x: x[0][1])
        host.sort(key=lambda x: (x[0][1], -x[0][2]))
        return cls([d for d, _ in dev], [h for h, _ in host], window_s,
                   devices,
                   spans=[(s[0], s[1], s[2], s[3], s[4] / 1e3, s[5] / 1e3)
                          for s in spans],
                   device_corr=[c for _, c in dev],
                   host_corr=[c for _, c in host])

    # -- the spans of the program's thread ------------------------------------

    def program_spans(self) -> List[tuple]:
        """The spans of the thread that recorded the most, sorted by
        (start, -end)."""
        if not self.spans:
            return []
        counts: Dict[int, int] = {}
        for s in self.spans:
            counts[s[3]] = counts.get(s[3], 0) + 1
        tid = max(counts, key=counts.get)
        return sorted((s for s in self.spans if s[3] == tid),
                      key=lambda s: (s[4], -s[5]))

    def launch_starts(self) -> List[Optional[float]]:
        """For each device event, the start of the host call that launched
        it (the call of the same correlation id whose name starts with
        "cu"), or None."""
        calls = {c: h[1] for h, c in zip(self.host, self.host_corr)
                 if c and h[0].startswith("cu")}
        return [calls.get(c) if c else None for c in self.device_corr]

    def _launched_in(self) -> Tuple[List[tuple], List[Tuple[int, Any]]]:
        """The program's spans, and (device event, index of the innermost
        span open when its launch call began, or None) for each device
        event whose launch call was traced."""
        spans = self.program_spans()
        starts = self.launch_starts()
        known = [i for i, t in enumerate(starts) if t is not None]
        return spans, list(zip(known, innermost(
            spans, [starts[i] for i in known])))

    def launch_spans(self) -> List[str]:
        """For each device event, the name of the innermost span open when
        its launch call began, ``OUTSIDE`` or ``NO_LAUNCH``."""
        spans, launched = self._launched_in()
        out = [NO_LAUNCH] * len(self.device)
        for i, j in launched:
            out[i] = OUTSIDE if j is None else spans[j][0]
        return out

    def device_seconds_by_span(self) -> Dict[str, float]:
        """Device seconds (each operation's length, summed) by the
        innermost span of its launch."""
        out: Dict[str, float] = {}
        for (_, s, t, _, _), name in zip(self.device, self.launch_spans()):
            out[name] = out.get(name, 0.0) + (t - s) / 1e6
        return out

    def device_seconds_inside(self, name: str) -> float:
        """Device seconds of the operations launched inside span ``name``,
        at any depth."""
        spans, launched = self._launched_in()
        by_id = {s[1]: s for s in spans}
        memo: Dict[int, bool] = {}

        def within(j: int) -> bool:
            s = spans[j]
            if s[1] not in memo:
                p = s
                while p is not None and p[0] != name:
                    p = by_id.get(p[2])
                memo[s[1]] = p is not None
            return memo[s[1]]

        return sum((self.device[i][2] - self.device[i][1]) / 1e6
                   for i, j in launched if j is not None and within(j))

    def idle_spans(self, min_us: float = 2.0) -> Dict[str, float]:
        """Idle seconds between device operations (device 0's, the gaps of
        ``idle_gaps``), summed by the innermost program span open at each
        gap's middle, ``OUTSIDE`` for the rest."""
        busy = self.busy_intervals(self.device[0][4] if self.device else 0)
        gaps = [(t0, s1) for (_, t0), (s1, _) in zip(busy, busy[1:])
                if s1 - t0 >= min_us]
        spans = self.program_spans()
        at = innermost(spans, [0.5 * (g0 + g1) for g0, g1 in gaps])
        out: Dict[str, float] = {}
        for (g0, g1), j in zip(gaps, at):
            label = OUTSIDE if j is None else spans[j][0]
            out[label] = out.get(label, 0.0) + (g1 - g0) / 1e6
        return out

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        out = super().breakdown()
        if self.spans and self.device:
            items = sorted(self.idle_spans().items(), key=lambda kv: -kv[1])
            out["idle_spans"] = [[k, v] for k, v in
                                 items[:harness.BREAKDOWN_ENTRIES]]
        return out


def span_cost_ns(n: int = 200000) -> Dict[str, float]:
    """ns a ``with span(...)`` block costs on this host, recorder on and
    off (an empty block's loop subtracted)."""
    from tpumil_torch.utils import prof

    def loop(use: bool) -> float:
        t0 = time.perf_counter_ns()
        if use:
            for _ in range(n):
                with prof.span("cost"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter_ns() - t0) / n

    empty = loop(False)
    off = loop(True) - empty
    with prof.recording():
        on = loop(True) - empty
    prof.collect()
    return {"on": on, "off": off}


def coverage(tr: SpanTrace) -> Dict[str, Any]:
    """How far the spans cover the window: kernel launches whose innermost
    span is a leaf (a span name no span of the window nests in), device
    seconds put down to any span, the pairing of device events with their
    launch calls, and the device seconds left over, by kernel."""
    names = tr.launch_spans()
    kernels = [n for e, n in zip(tr.device, names) if e[3] == "kernel"]
    by_id = {s[1]: s[0] for s in tr.spans}
    leaves = {s[0] for s in tr.spans} - {by_id.get(s[2]) for s in tr.spans}
    total = sum(t - s for _, s, t, _, _ in tr.device) / 1e6
    left: Dict[str, float] = {}
    for (name, s, t, _, _), where in zip(tr.device, names):
        if where in (OUTSIDE, NO_LAUNCH):
            key = f"{where}: {name[:harness.KERNEL_NAME_CHARS]}"
            left[key] = left.get(key, 0.0) + (t - s) / 1e6
    attributed = total - sum(left.values())
    launches: Dict[str, int] = {}
    for n in kernels:
        launches[n] = launches.get(n, 0) + 1
    return {
        "kernel_launches": len(kernels),
        "launches_by_span": launches,
        "launches_in_leaf_pct": (100.0 * sum(n in leaves for n in kernels)
                                 / len(kernels)) if kernels else None,
        "device_s": total,
        "device_s_by_span": tr.device_seconds_by_span(),
        "device_attributed_pct": 100.0 * attributed / total if total else None,
        "paired_with_launch": sum(n != NO_LAUNCH for n in names),
        "device_events": len(names),
        "left_over": sorted(([k, v] for k, v in left.items()),
                            key=lambda kv: -kv[1])[:harness.BREAKDOWN_ENTRIES],
    }


def measure(root: Path, workload: str, seed: int, seconds: float,
            recorder: bool, device) -> Dict[str, Any]:
    """One cell's set-up and a window under the profiler, the recorder on
    or off; the result object (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpumil_torch.utils import prof

    on_cuda = device.type == "cuda"
    scratch = harness.make_scratch(workload)
    try:
        cell = harness.load_cell(root, workload, seed, device, scratch)
        manifest = harness.load_manifest(root)
        driver = harness.load_driver(root, cell.spec["driver"])
        state = driver.setup(cell)
        if on_cuda:
            torch.cuda.synchronize()
        prof.collect()
        p = profile(activities=[ProfilerActivity.CUDA if on_cuda
                                else ProfilerActivity.CPU])
        p.__enter__()
        w0 = harness.now()
        try:
            with prof.recording() if recorder else contextlib.nullcontext():
                win = driver.window(state, seconds)
                if on_cuda:
                    torch.cuda.synchronize()
        finally:
            traced_s = harness.now() - w0
            p.__exit__(None, None, None)
        tr = SpanTrace.from_profiler(p, traced_s, 1, prof.collect())
        p = None
        ctx = harness.ReadContext(cell, tr, win, harness.peaks(root))
        names = [m["name"] for m in
                 harness.cell_metrics(manifest, workload, "per_layer")]
        names += list(SPAN_METRICS.get(workload, ()))
        metrics: Dict[str, Optional[float]] = {
            n: harness.metric_reader(root, n).read(ctx, n) for n in names}
        for m in harness.cell_metrics(manifest, workload, "end_to_end"):
            if m["source"] == "device_trace":
                metrics[m["name"]] = harness.metric_reader(
                    root, m["name"]).read(ctx, m["name"])
            elif m["name"] in win.end_to_end:
                metrics[m["name"]] = win.end_to_end[m["name"]]
        counts: Dict[str, int] = {}
        for s in tr.spans:
            counts[s[0]] = counts.get(s[0], 0) + 1
        result = {
            "workload": workload, "seed": seed, "recorder": recorder,
            "window_s": tr.window_s, "busy_s": tr.busy_s,
            "steps": win.counters.get("steps"), "metrics": metrics,
            "span_counts": counts, "coverage": coverage(tr),
            "breakdown": tr.breakdown(), "span_cost_ns": span_cost_ns(),
            "device": (harness.card_identity(1) if on_cuda
                       else {"platform": "cpu"})}
        driver.close(state)
        return result
    finally:
        harness.remove_scratch(scratch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("[portbench.spans] no CUDA card")
        return 2
    result = measure(root, args.workload, args.seed, args.seconds,
                     bool(args.recorder), torch.device("cuda", 0))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
