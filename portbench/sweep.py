"""The sweep that finds the highest rate a serving cell sustains: one
set-up, then one window at each offered rate, in this one process.

    python3 -m portbench.sweep --workload tcga-serve --seed 1 \
        --seconds 20 --rates 10 20 30 40

For each rate it prints one JSON line: the offered and the served patches
per second, the median and the 95th percentile of latency, the 95th
percentile of how late requests were sent, and the failures. The highest
rate whose served rate keeps up with the offered one and whose tail does
not grow with the window is the sustained rate; a cell's file takes 0.8
of it as a number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", nargs="+", type=float, required=True)
    args = p.parse_args(argv)
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("[sweep] no CUDA card")
        return 2
    scratch = harness.make_scratch(args.workload)
    try:
        cell = harness.load_cell(root, args.workload, args.seed,
                                 torch.device("cuda", 0), scratch)
        driver = harness.load_driver(root, cell.spec["driver"])
        state = driver.setup(cell)
        for rate in args.rates:
            cell.traffic["rate_per_s"] = rate
            win = driver.window(state, args.seconds)
            c = win.counters
            offered = sum(state.sizes) / args.seconds
            print(json.dumps({
                "rate_per_s": rate, "requests": win.attempted,
                "offered_patches_per_s": offered,
                "served_patches_per_s": c["served_patches_per_s"],
                "p50_ms": c["p50_ms"], **win.end_to_end,
                "late_p95_ms": c["late_p95_ms"], "failed": win.failed,
                "window_s": win.seconds}), flush=True)
        driver.observe(state)
        driver.close(state)
    finally:
        harness.remove_scratch(scratch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
