"""Where a training step's time goes on the card: one bag step (forward,
backward, Adam) of ``tpumil_torch``'s BagTrainer, for DSMIL on the kernel
route (K1-K3) and on the eager route, for the other registry models on the
eager route, broken down by device kernel.

    python -m tools.train_profile                # on a CUDA card
    python -m tools.train_profile --sizes 17 --feats_size 166 \
        --num_classes 1 --model abmil            # a musk-sized bag
    python -m tools.train_profile --device cpu --sizes 300 --feats_size 32
                                                 # a quick CPU dry run

For each bag size and route, after 3 warm-up steps: the host-clock wall
per step over ``--steps`` steps without the profiler, then
``torch.profiler`` over as many steps: device time per step (the union of
kernel and copy intervals), its share of the unprofiled wall (the
profiler's own host cost inflates the profiled wall) and each kernel
class's share of the device time. When the trace holds no device event (as
on the CPU), the device numbers say "not measured".
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import profile

from tools.serve_profile import (activities, busy_us, device_events, gpu_line,
                                 log, sync)

# kernel class -> substrings of the (lower-cased) kernel name, tried in order
CLASSES = (
    ("K1 fwd", ("pool_logits_kernel", "pool_attend_kernel",
                "pool_merge_kernel")),
    ("K2 bwd1", ("pool_bwd1_",)),
    ("K3 bwd2", ("pool_bwd2_",)),
    ("K3 partial sums", ("reduce_partials",)),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "cublas")),
    ("adam", ("adam", "multi_tensor")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "softmax",
                            "index", "gather", "scatter", "argmax")),
)


def classify(event: Dict) -> str:
    if event["cat"] != "kernel":
        return "copy/memset"
    name = event["name"].lower()
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def shares(events: List[Dict]):
    by_class: Dict[str, float] = defaultdict(float)
    for e in events:
        by_class[classify(e)] += float(e["dur"])
    total = sum(by_class.values())
    return total, {k: v / total for k, v in
                   sorted(by_class.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--sizes", type=int, nargs="+", default=[4000, 65529])
    parser.add_argument("--feats_size", type=int, default=512)
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--model", default="dsmil",
                        choices=["dsmil", "abmil", "meanpool", "maxpool"])
    args = parser.parse_args(argv)

    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    cfg = DSMILConfig(args.feats_size, args.num_classes)
    rng = np.random.default_rng(0)
    label = torch.eye(args.num_classes, device=dev)[0]
    for n in args.sizes:
        feats = torch.from_numpy(
            rng.standard_normal((n, args.feats_size), np.float32)).to(dev)
        routes = (("kernel", True), ("eager", False))
        for route, fused in routes if args.model == "dsmil" else routes[1:]:
            trainer = BagTrainer(cfg, weight_decay=1e-3, model=args.model,
                                 device=dev)
            model, opt = trainer.init(torch.Generator().manual_seed(0))
            gen = torch.Generator(device=dev).manual_seed(0)
            items = [(feats, label)]
            trainer._train_bags(model, opt, items * 3, fused, gen)
            sync(dev)
            t0 = time.perf_counter()
            trainer._train_bags(model, opt, items * args.steps, fused, gen)
            sync(dev)
            wall = (time.perf_counter() - t0) / args.steps
            with profile(activities=activities(dev)) as prof:
                trainer._train_bags(model, opt, items * args.steps, fused, gen)
                sync(dev)
            events = device_events(prof)
            head = (f"[step] {args.model} N={n} K={args.feats_size} "
                    f"C={args.num_classes} {route} route: wall {wall * 1e3:.3f} ms/step over "
                    f"{args.steps} steps")
            if not events:
                log(f"{head}; device time not measured (no device events in "
                    f"the trace)")
                continue
            total, share = shares(events)
            busy = busy_us(events) / args.steps
            log(f"{head}; device busy {busy / 1e3:.3f} ms/step = "
                f"{busy / (wall * 1e6) * 100:.1f}% of the wall (kernel time "
                f"{total / args.steps / 1e3:.3f} ms); "
                + ", ".join(f"{k} {v * 100:.1f}%" for k, v in share.items())
                + f"; {gpu}")
        del feats
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
