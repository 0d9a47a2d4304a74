"""Where the inst-sharded bag step's time goes against the eager step: one
Adam step of ``tpumil_torch``'s InstanceShardedBagTrainer at world 1 (NCCL
on the card: NCCL refuses two ranks on one GPU) and of the eager
BagTrainer, on the same bag.

    python -m tools.shard_profile                  # on a CUDA card
    python -m tools.shard_profile --device cpu --sizes 300 --feats_size 32
                                                   # a quick CPU dry run (gloo)

For each bag size, after 3 warm-up steps: the host-clock wall per step over
``--steps`` steps, the two routes in turns (sharded, eager, sharded,
eager); the host time spent inside the sharded step's collectives (a clock
around each call of ``parallel.bag_shard.collective``); then
``torch.profiler`` over as many steps of each route: device time per step
(the union of kernel and copy intervals), its share of the unprofiled wall,
and each kernel class's share of the device time. When the trace holds no
device event (as on the CPU), the device numbers say "not measured".
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

CLASSES = (
    ("nccl", ("nccl",)),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "cublas")),
    ("adam", ("adam", "multi_tensor")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "softmax",
                            "index", "gather", "scatter", "argmax", "cat")),
)


def shares(events: List[Dict]):
    by_class: Dict[str, float] = defaultdict(float)
    for e in events:
        name = e["name"].lower()
        label = "copy/memset" if e["cat"] != "kernel" else next(
            (lab for lab, keys in CLASSES if any(k in name for k in keys)),
            "other")
        by_class[label] += float(e["dur"])
    total = sum(by_class.values())
    return total, {k: v / total for k, v in
                   sorted(by_class.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--sizes", type=int, nargs="+", default=[4000, 65529])
    parser.add_argument("--feats_size", type=int, default=512)
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.parallel import bag_shard, mesh
    from tpumil_torch.train.trainer import BagTrainer
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    world = mesh.make_mesh(1, 1, dev.type)
    log(f"[world] {dist.get_world_size()} rank on {dist.get_backend()}")
    cfg = DSMILConfig(args.feats_size, args.num_classes)
    rng = np.random.default_rng(0)
    label = torch.eye(args.num_classes, device=dev)[0]

    inner = bag_shard.collective
    host = [0.0]

    def timed(op, x, group):
        t0 = time.perf_counter()
        out = inner(op, x, group)
        host[0] += time.perf_counter() - t0
        return out

    # the wrapped function counts its calls in the module's ``collective``
    timed.calls = 0
    bag_shard.collective = timed
    try:
        for n in args.sizes:
            feats = torch.from_numpy(
                rng.standard_normal((n, args.feats_size), np.float32)).to(dev)
            items = [(feats, label)]
            routes = {
                "sharded": bag_shard.InstanceShardedBagTrainer(
                    cfg, weight_decay=1e-3, device=dev, mesh=world),
                "eager": BagTrainer(cfg, weight_decay=1e-3,
                                    fused_threshold=None, device=dev)}
            state = {}
            for route, trainer in routes.items():
                model, opt = trainer.init(torch.Generator().manual_seed(0))
                gen = torch.Generator(device=dev).manual_seed(0)
                trainer._train_bags(model, opt, items * 3, False, gen)
                state[route] = (trainer, model, opt, gen)
            walls = defaultdict(list)
            for route in ("sharded", "eager", "sharded", "eager"):
                trainer, model, opt, gen = state[route]
                sync(dev)
                host[0], bag_shard.collective.calls = 0.0, 0
                t0 = time.perf_counter()
                trainer._train_bags(model, opt, items * args.steps, False, gen)
                sync(dev)
                walls[route].append((time.perf_counter() - t0) / args.steps)
                if route == "sharded":
                    calls = bag_shard.collective.calls / args.steps
                    coll_ms = host[0] / args.steps * 1e3
            log(f"[step] N={n} K={args.feats_size} C={args.num_classes}: "
                f"wall ms/step over {args.steps} steps, in turns: sharded "
                + " / ".join(f"{w * 1e3:.3f}" for w in walls["sharded"])
                + ", eager " + " / ".join(f"{w * 1e3:.3f}"
                                          for w in walls["eager"])
                + f"; sharded: {calls:.0f} collectives a step, {coll_ms:.3f} "
                f"ms of host time inside them; {gpu}")
            for route in ("sharded", "eager"):
                trainer, model, opt, gen = state[route]
                with profile(activities=activities(dev)) as prof:
                    trainer._train_bags(model, opt, items * args.steps, False,
                                        gen)
                    sync(dev)
                events = device_events(prof)
                if not events:
                    log(f"[trace] N={n} {route}: device time not measured (no "
                        f"device events in the trace)")
                    continue
                total, share = shares(events)
                busy = busy_us(events) / args.steps
                wall = min(walls[route]) * 1e6
                log(f"[trace] N={n} {route}: device busy {busy / 1e3:.3f} "
                    f"ms/step = {busy / wall * 100:.1f}% of the wall (kernel "
                    f"time {total / args.steps / 1e3:.3f} ms); "
                    + ", ".join(f"{k} {v * 100:.1f}%" for k, v in share.items())
                    + f"; {gpu}")
            del feats, state
    finally:
        bag_shard.collective = inner
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
