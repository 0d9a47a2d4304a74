"""Where the time goes in feature extraction on the card: ``tpumil_torch``'s
compute_feats over bags of slide size, traced.

    python -m tools.extract_profile              # on a CUDA card
    python -m tools.extract_profile --device cpu --bags 2 --patches 16 \\
        --patch_size 64 --batch_size 4           # a quick CPU dry run

Phases (each prints its own lines):
  1. tree    -- ``--bags`` bags of ``--patches`` JPEG patches each (smooth
                fields plus noise, quality 90, bags alternating between two
                classes), written by a thread pool in a temporary directory.
  2. cli     -- ``python -m tpumil_torch.cli.compute_feats`` as a
                subprocess: its wall and its ``Throughput:`` line.
  3. decode  -- the host pipeline alone: ``PatchBatchLoader`` over each bag
                in turn, as the extractor runs it (one loader per bag), with
                the wait for each bag's first batch; then one loader over
                the whole tree.
  4. extract -- compute_feats in-process on the same tree after one warm-up
                batch: the host-clock wall without the profiler, then again
                under ``torch.profiler``: the device's busy share of the
                wall (the union of kernel, copy and memset intervals), its
                time per batch and each kernel class's share of it.

Device numbers come from the profiler's chrome trace; when it holds no
device event (as on the CPU), the device lines say "not measured".
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import profile

from tools.serve_profile import (activities, busy_us, device_events, gpu_line,
                                 log, sync)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "synth"
# kernel class -> substrings of the (lower-cased) kernel name, tried in order
CLASSES = (
    ("stem kernel (K5)", ("stem_conv_kernel", "stem_norm_pool_kernel")),
    ("IN kernel (K4)", ("instance_norm_kernel",)),
    ("layout transpose", ("nhwctonchw", "nchwtonhwc")),
    ("conv/gemm", ("conv", "xmma", "gemm", "cudnn", "implicit", "cutlass",
                   "winograd", "fft", "sm90_")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized")),
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


def write_patch(path: str, size: int, seed) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    field = Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).resize(
        (size, size), Image.BICUBIC)
    arr = np.clip(np.asarray(field, np.int16)
                  + rng.integers(-20, 21, (size, size, 3)), 0, 255)
    Image.fromarray(arr.astype(np.uint8)).save(path, quality=90)


def write_tree(root: str, bags: int, patches: int, size: int,
               seed: int) -> List[str]:
    """``<root>/synth/single/class{b % 2}/bag{b}/<col>_<row>.jpeg``, written
    by a thread pool; returns the bag directories."""
    side = int(np.ceil(np.sqrt(patches)))
    jobs, bag_dirs = [], []
    for b in range(bags):
        d = os.path.join(root, DATASET, "single", f"class{b % 2}", f"bag{b}")
        os.makedirs(d)
        bag_dirs.append(d)
        jobs += [(os.path.join(d, f"{p % side}_{p // side}.jpeg"), (b, p))
                 for p in range(patches)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(lambda j: write_patch(j[0], size, (seed, *j[1])), jobs))
    return bag_dirs


def phase_tree(root: str, args) -> List[str]:
    t0 = time.perf_counter()
    bag_dirs = write_tree(root, args.bags, args.patches, args.patch_size,
                          args.seed)
    log(f"[tree] {args.bags} bags x {args.patches} JPEG patches of "
        f"{args.patch_size}^2 written in {time.perf_counter() - t0:.2f} s "
        f"({os.cpu_count()} threads)")
    return bag_dirs


def phase_cli(tmp: str, args, gpu: str) -> None:
    cmd = [sys.executable, "-m", "tpumil_torch.cli.compute_feats",
           "--device", args.device, "--dataset", DATASET,
           "--weights", "model.pth", "--precision", args.precision,
           "--batch_size", str(args.batch_size),
           "--patch_size", str(args.patch_size),
           "--num_workers", str(args.num_workers)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          timeout=1800, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"compute_feats exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    (line,) = [l for l in proc.stdout.splitlines()
               if l.startswith("Throughput")]
    log(f"[cli] {' '.join(cmd[1:])}: exit 0 in {wall:.2f} s (start-up "
        f"included); {line}; {gpu}")


def phase_decode(bag_paths: List[List[str]], args) -> None:
    from tpumil_torch.data.patches import PatchBatchLoader

    n = sum(len(p) for p in bag_paths)
    first = []
    t0 = time.perf_counter()
    for paths in bag_paths:
        t = time.perf_counter()
        batches = iter(PatchBatchLoader(paths, args.batch_size,
                                        args.patch_size, args.num_workers))
        next(batches)
        first.append(time.perf_counter() - t)
        for _ in batches:
            pass
    per_bag = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in PatchBatchLoader([p for ps in bag_paths for p in ps],
                              args.batch_size, args.patch_size,
                              args.num_workers):
        pass
    whole = time.perf_counter() - t0
    log(f"[decode] host JPEG decode alone ({args.num_workers} threads, batch "
        f"{args.batch_size}, {os.cpu_count()} cores): one loader per bag "
        f"{n / per_bag:.1f} patches/s, each bag's first batch after "
        f"{', '.join(f'{s * 1e3:.1f}' for s in first)} ms; one loader over "
        f"the tree {n / whole:.1f} patches/s")


def phase_extract(tmp: str, bag_dirs: List[str], bag_paths: List[List[str]],
                  dev: torch.device, args, gpu: str) -> None:
    from tpumil_torch.infer.features import (ExtractorStats, FeatureExtractor,
                                             compute_feats)
    from tpumil_torch.models import embedder

    cfg = embedder.EmbedderConfig(precision=args.precision,
                                  space_to_depth=True)  # the CLI's defaults
    model = embedder.load_simclr_checkpoint(
        os.path.join(tmp, "model.pth"), cfg, dev)
    ex = FeatureExtractor(model, args.batch_size, args.patch_size,
                          args.num_workers)
    ex.embed_paths(bag_paths[0][:args.batch_size])  # warm-up
    n = sum(len(p) for p in bag_paths)
    batches = sum(-(-len(p) // args.batch_size) for p in bag_paths)
    ex.stats = ExtractorStats()
    t0 = time.perf_counter()
    compute_feats(bag_dirs, ex, os.path.join(tmp, "plain_run"))
    sync(dev)
    wall = time.perf_counter() - t0
    with profile(activities=activities(dev)) as prof:
        t0 = time.perf_counter()
        compute_feats(bag_dirs, ex, os.path.join(tmp, "traced_run"))
        sync(dev)
        traced = time.perf_counter() - t0
    log(f"[extract] compute_feats in-process, {args.precision}, {n} patches "
        f"in {len(bag_dirs)} bags ({batches} batches of {args.batch_size}): "
        f"wall {wall:.3f} s = {n / wall:.1f} patches/s; under the profiler "
        f"{traced:.3f} s = {n / traced:.1f} patches/s; {gpu}")
    events = device_events(prof)
    if not events:
        log("[extract] device busy share: not measured (no device events in "
            "the trace)")
        return
    busy = busy_us(events) / 1e6
    total, share = shares(events)
    log(f"[extract] device busy {busy:.3f} s = {busy / traced * 100:.1f}% of "
        f"the traced wall ({busy / wall * 100:.1f}% of the untraced one); "
        f"device time {total / 1e6:.3f} s = {total / batches / 1e3:.3f} ms "
        f"per batch: " + ", ".join(f"{k} {v * 100:.1f}%"
                                   for k, v in share.items()) + f"; {gpu}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # SURVEY.md: 10^3-10^4 patches per slide
    p.add_argument("--bags", type=int, default=3)
    p.add_argument("--patches", type=int, default=4096)
    p.add_argument("--patch_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from tpumil_torch.data.patches import list_patches
    from tpumil_torch.models import embedder
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        bag_dirs = phase_tree(os.path.join(tmp, "WSI"), args)
        bag_paths = [list_patches(d) for d in bag_dirs]
        src = embedder.init_params(args.seed, embedder.EmbedderConfig(),
                                   torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(src),
                   os.path.join(tmp, "model.pth"))
        phase_cli(tmp, args, gpu)
        phase_decode(bag_paths, args)
        phase_extract(tmp, bag_dirs, bag_paths, dev, args, gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
