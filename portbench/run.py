"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (inputs and weights from the seed,
warm-up, the steps the check follows) is timed as ``setup_s`` from process
start; then ``--seconds`` of measured work (under the profiler with
``--trace 1``, and in every run of a cell with an end-to-end metric read
from the device's trace); then, with the peak memory read and the program's state
freed, the comparison with the plain reference that decides ``correct``.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result. Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # process start, as near as the script can see it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

if __package__ in (None, ""):  # run as a file: import the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.harness import BenchError, log  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    if args.seconds <= 0:
        p.error("--seconds must be > 0")
    return args


def check_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float,
             chips: Optional[int] = None) -> Dict[str, Any]:
    """Set up, measure and check one cell on ``device``; returns the
    result object. ``main`` looks for the cards first; tests call this on
    the CPU at small sizes."""
    import torch

    on_cuda = device.type == "cuda"
    scratch = harness.make_scratch(workload)
    try:
        cell = harness.load_cell(root, workload, seed, device, scratch)
        chips = chips or int(cell.entry["chips"])
        manifest = harness.load_manifest(root)
        driver = harness.load_driver(root, cell.spec["driver"])
        state = driver.setup(cell)
        if on_cuda:
            torch.cuda.synchronize()
        setup_s = harness.now() - t0
        log(f"[portbench] {workload} seed {seed}: set-up {setup_s:.3f} s")

        e2e = harness.cell_metrics(manifest, workload, "end_to_end")
        # an end-to-end metric read from the device's trace puts the
        # window under the profiler in every run of the cell
        profiled = trace or any(m["source"] == "device_trace" for m in e2e)
        sampler = harness.SmiSampler(chips).start() if on_cuda else None
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA if on_cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        w0 = harness.now()
        try:
            win = driver.window(state, seconds)
            if on_cuda:
                torch.cuda.synchronize()
        finally:
            traced_s = harness.now() - w0
            if prof is not None:
                prof.__exit__(None, None, None)
            smi = sampler.stop() if sampler is not None else {}
        log(f"[portbench] window {win.seconds:.3f} s, attempted "
            f"{win.attempted}, failed {win.failed}")

        device_info: Dict[str, Any] = (
            harness.card_identity(chips) if on_cuda
            else {"platform": "cpu", "kind": "cpu", "count": 1})
        device_info["memory_peak_bytes"] = (
            harness.memory_peak_bytes(chips) if on_cuda else 0)
        device_info.update(smi)

        metrics: Dict[str, Dict[str, Any]] = {}
        breakdown = ctx = None
        if profiled:
            tr = harness.Trace.from_profiler(prof, traced_s, chips)
            prof = None
            ctx = harness.ReadContext(cell, tr, win, harness.peaks(root))
        if trace:
            device_info["busy_s"] = ctx.trace.busy_s
            device_info["window_s"] = ctx.trace.window_s
            for m in harness.cell_metrics(manifest, workload, "per_layer"):
                value = harness.metric_reader(root, m["name"]).read(
                    ctx, m["name"])
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
            breakdown = ctx.trace.breakdown()
        else:
            for m in e2e:
                if m["name"] == "setup_s":
                    value = setup_s
                elif m["source"] == "device_trace":
                    value = harness.metric_reader(root, m["name"]).read(
                        ctx, m["name"])
                    if value is None:  # no device in the trace (the CPU)
                        continue
                else:
                    value = win.end_to_end[m["name"]]
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if profiled:
            log(f"[portbench] traced window {ctx.trace.window_s:.3f} s, "
                f"device busy {ctx.trace.busy_s:.6f} s")
        tr = ctx = None

        observed = driver.observe(state)
        readings = driver.reference(state, observed, "stated")
        compared: List[harness.Compared] = driver.compare(state, observed,
                                                          readings)
        driver.close(state)
        correct = bool(compared) and all(c.ok for c in compared)

        result: Dict[str, Any] = {
            "correct": correct, "attempted": int(win.attempted),
            "failed": int(win.failed), "metrics": metrics,
            "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        # a number that is not finite is written as the largest double
        # (JSON has no NaN), which is over every limit
        result["compared"] = {
            c.name: {"value": c.value if math.isfinite(c.value)
                     else sys.float_info.max, "limit": c.limit}
            for c in compared}
        return result
    finally:
        harness.remove_scratch(scratch)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    try:
        manifest = harness.load_manifest(root)
        chips = int(harness.workload_entry(manifest, args.workload)["chips"])
        check_cards(chips)
        import torch

        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T0,
                          chips)
        bad = harness.forbidden_loaded()
        if bad:
            raise BenchError(f"modules that must not load in this process: "
                             f"{', '.join(bad)}")
    except BenchError as e:
        log(f"[portbench] no result: {e}")
        return 2
    for name, c in result["compared"].items():
        log(f"[portbench] compared {name} = {c['value']!r} "
            f"(limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'OVER'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
