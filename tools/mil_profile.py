"""The wall of a classic-MIL benchmark run on the card, at train_mil's
default folds and epochs, for each registry model, and where it goes.

    python -m tools.mil_profile                  # musk1_mini, 10 x 40, 4 models
    python -m tools.mil_profile --device cpu --cv_fold 3 --num_epoch 1 \
        --models meanpool                        # a quick CPU dry run

For each model: ``python -m tpumil_torch.cli.train_mil`` as a subprocess,
the wall from its start to its exit, with the host-clock time at which its
``Dataset:`` line (interpreter and imports done) and its first epoch line
arrive; then ``run_mil_cv`` in-process on the same data after a warm-up
run, its wall and that wall over the run's train steps (evaluations
included). The CLI's wall less the in-process wall is what the process
start-up and its first device work cost.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from tools.serve_profile import REPO, gpu_line, log, sync

MUSK = os.path.join(REPO, "tests", "data", "musk1_mini.svm")


def cli_wall(model: str, args) -> dict:
    """Run the CLI once; host-clock times of its milestones in s."""
    cmd = [sys.executable, "-u", "-m", "tpumil_torch.cli.train_mil",
           "--data_file", args.data_file, "--num_feats", str(args.num_feats),
           "--cv_fold", str(args.cv_fold), "--num_epoch", str(args.num_epoch),
           "--model", model, "--device", args.device]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    marks, tail = {}, []
    with subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            now = time.perf_counter() - t0
            if line.startswith("Dataset:"):
                marks.setdefault("dataset", now)
            elif " epoch 1/" in line:
                marks.setdefault("first_epoch", now)
            tail = (tail + [line])[-20:]
        rc = proc.wait()
    marks["exit"] = time.perf_counter() - t0
    if rc != 0 or not any("Cross validation accuracy mean" in l for l in tail):
        raise RuntimeError(f"train_mil --model {model} exited {rc}:\n"
                           + "".join(tail))
    marks["result"] = tail[-1].strip()
    return marks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--data_file", default=MUSK)
    parser.add_argument("--num_feats", type=int, default=166)
    parser.add_argument("--cv_fold", type=int, default=10)
    parser.add_argument("--num_epoch", type=int, default=40)
    parser.add_argument("--models", nargs="+",
                        default=["dsmil", "abmil", "meanpool", "maxpool"])
    args = parser.parse_args(argv)

    from tpumil_torch.data.mil_bench import (cross_validation_split,
                                             parse_mil_file)
    from tpumil_torch.train import schemes
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    bags = parse_mil_file(args.data_file, num_feats=args.num_feats)
    idx = list(range(len(bags)))
    steps = args.num_epoch * sum(
        len(cross_validation_split(idx, args.cv_fold, k)[0])
        for k in range(args.cv_fold))
    log(f"[mil] {os.path.basename(args.data_file)}: {len(bags)} bags, "
        f"K={args.num_feats}, {args.cv_fold} folds x {args.num_epoch} epochs "
        f"= {steps} train steps; {gpu}")
    for model in args.models:
        m = cli_wall(model, args)
        log(f"[mil] {model}: train_mil wall {m['exit']:.2f} s; Dataset: line "
            f"at {m['dataset']:.2f} s, first epoch line at "
            f"{m['first_epoch']:.2f} s; {m['result']}; {gpu}")
        cfg = dict(num_feats=args.num_feats, model=model, verbose=False,
                   device=dev)
        schemes.run_mil_cv(bags, schemes.MILBenchConfig(
            **cfg, cv_fold=2, num_epochs=1), log=lambda s: None)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        _, _, accs = schemes.run_mil_cv(bags, schemes.MILBenchConfig(
            **cfg, cv_fold=args.cv_fold, num_epochs=args.num_epoch),
            log=lambda s: None)
        sync(dev)
        wall = time.perf_counter() - t0
        log(f"[mil] {model}: run_mil_cv in-process {wall:.2f} s, "
            f"{wall / steps * 1e3:.3f} ms per train step (evaluations "
            f"included); start-up and first device work {m['exit'] - wall:.2f} s; "
            f"fold accuracies {accs}; {gpu}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
