"""Readings that set a cell's limits: for each seed, the numbers the check
compares for the program (sound, or with a fault planted underneath), and
for the control, the plain reference computed in the next lower precision
in the program's place.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 \
        [--seconds 0.01] [--fault <name>] [--control] [--out <file>]

Each seed runs the cell's set-up and a short window (one unit of the
cell's work when ``--seconds`` is small), all in this one process; one
JSON line a seed goes to standard output (and to ``--out``). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, harness  # noqa: E402


def readings(root: Path, workload: str, seed: int, seconds: float,
             device, fault: str = "", control: bool = False,
             detail: bool = False) -> dict:
    """{number: value} for one seed: the program's (with ``fault``
    planted), and with ``control`` the control's as well; with ``detail``
    also what was compared (the training cells' leaf norms)."""
    undo = faults.PLANT[fault]() if fault else None
    scratch = harness.make_scratch(workload)
    try:
        cell = harness.load_cell(root, workload, seed, device, scratch)
        driver = harness.load_driver(root, cell.spec["driver"])
        state = driver.setup(cell)
        driver.window(state, seconds)
        observed = driver.observe(state)
        ref = driver.reference(state, observed, "stated")
        out = {"seed": seed, "fault": fault or None, "program": {
            c.name: c.value for c in driver.compare(state, observed, ref)}}
        if detail:
            out["detail"] = {"observed": observed, "reference": ref}
        if control:
            low = driver.reference(state, observed, "lower")
            out["control"] = {c.name: c.value for c in driver.compare(
                state, driver.as_observed(state, observed, low), ref)}
            if detail:
                out["detail"]["control"] = low
        driver.close(state)
        return out
    finally:
        if undo is not None:
            undo()
        harness.remove_scratch(scratch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=0.01)
    p.add_argument("--fault", default="", choices=("",) + faults.FAULTS)
    p.add_argument("--control", action="store_true")
    p.add_argument("--detail", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        harness.log("[calibrate] no CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        line = json.dumps(readings(root, args.workload, seed, args.seconds,
                                   dev, args.fault, args.control,
                                   args.detail), default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
