"""Where the time goes in inference and heatmaps on the card: ``tpumil_torch``'s
attention_map path over one slide-sized bag.

    python -m tools.heatmap_profile              # on a CUDA card
    python -m tools.heatmap_profile --device cpu --patches 16 \\
        --batch_sizes 4 8                        # a quick CPU dry run

Phases (each prints its own lines):
  1. bag     -- one bag of ``--patches`` 224^2 JPEG patches (smooth fields
                plus noise, quality 90) filling a square tile grid (4096
                patches: 64 x 64 tiles), written by a thread pool.
  2. cli     -- ``python -m tpumil_torch.cli.attention_map`` as a subprocess
                at its defaults (f32, batch 64) with the shipped TCGA
                aggregator, ``--export_scores 1 --seed 0``: its wall and
                patches/s, start-up included.
  3. decode  -- the host pipeline alone: ``PatchBatchLoader`` over the bag
                at each batch size, batches dropped.
  4. infer   -- per ``--batch_sizes`` entry, ``run_attention_maps`` in-process
                after a warm-up batch and the aggregator's first two calls
                (timed): patches/s, the wall split into decode
                and embed, aggregate, render, PNG and CSV, and the K5 and K4
                launches (1 and 19 per batch on the card); then the same run
                under ``torch.profiler``: the device's busy share of the wall
                (the union of kernel, copy and memset intervals), its time
                per batch and each kernel class's share.
  5. render  -- the host memory of the render and PNG of that grid (the
                x32 map is float64: 64 x 64 tiles give 2048^2 x 3 x 8 B),
                as tracemalloc's peak.

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
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import profile

from tools.extract_profile import shares, write_patch
from tools.serve_profile import (activities, busy_us, device_events, gpu_line,
                                 log, sync)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGGREGATOR = os.path.join(REPO, "tests", "data", "tcga_aggregator.pth")
# testing_tcga's shipped thresholds (LUAD, LUSC)
THRESHOLDS = [0.45798203349113464, 0.5827295184135437]
CLASSES = ["LUAD", "LUSC"]


def write_bag(bag_dir: str, n: int, size: int, seed: int,
              holes: bool = False) -> int:
    """``n`` JPEG patches ``<row>_<col>.jpg`` of ``size``^2 over the cells
    of a square grid, row by row; ``holes`` skips every cell with
    ``(row + 2 col) % 5 == 0``, so that the heatmap's scatter leaves gaps.
    Returns the grid's side."""
    keep = 0.8 if holes else 1.0
    side = int(np.ceil(np.sqrt(n / keep)))
    cells = [(r, c) for r in range(side + 1) for c in range(side)
             if not (holes and (r + 2 * c) % 5 == 0)][:n]
    assert len(cells) == n
    os.makedirs(bag_dir, exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(lambda k: write_patch(
            os.path.join(bag_dir, f"{cells[k][0]}_{cells[k][1]}.jpg"), size,
            (seed, k)), range(n)))
    return side


def phase_cli(tmp: str, bag_root: str, args, gpu: str) -> None:
    cmd = [sys.executable, "-m", "tpumil_torch.cli.attention_map",
           "--device", args.device, "--embedder_weights", "model.pth",
           "--aggregator_weights", AGGREGATOR, "--bag_path", bag_root,
           "--map_path", "cli_maps", "--export_scores", "1", "--score_path",
           "cli_scores", "--seed", "0", "--thres", *map(str, THRESHOLDS),
           "--class_name", *CLASSES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          timeout=1800, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"attention_map exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[cli] python -m tpumil_torch.cli.attention_map --device "
        f"{args.device} (f32, batch 64, 8 workers): exit 0 in {wall:.2f} s "
        f"(start-up included) = {args.patches / wall:.1f} patches/s; it "
        f"printed: {proc.stdout.strip().splitlines()[-1]}; {gpu}")


def phase_decode(bag_dir: str, args) -> None:
    from tpumil_torch.data.patches import PatchBatchLoader, list_patches

    paths = list_patches(bag_dir, exts=("jpg",))
    for batch in args.batch_sizes:
        t0 = time.perf_counter()
        for _ in PatchBatchLoader(paths, batch, 224, args.num_workers):
            pass
        wall = time.perf_counter() - t0
        log(f"[decode] host JPEG decode alone ({args.num_workers} threads, "
            f"batch {batch}, {os.cpu_count()} cores): {len(paths)} patches in "
            f"{wall:.3f} s = {len(paths) / wall:.1f} patches/s")


def stage_split(stats) -> str:
    stages = (("decode+embed", stats.embed_seconds),
              ("aggregate", stats.aggregate_seconds),
              ("render", stats.render_seconds), ("PNG", stats.png_seconds),
              ("CSV", stats.csv_seconds))
    total = sum(s for _, s in stages)
    return ", ".join(f"{name} {s:.3f} s ({s / total * 100:.1f}%)"
                     for name, s in stages)


def phase_infer(tmp: str, bag_dirs, dev: torch.device, batch: int, args,
                gpu: str):
    from tpumil_torch.cli.attention_map import load_milnet
    from tpumil_torch.infer.heatmap import (BagInference, HeatmapStats,
                                            run_attention_maps)
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem

    emb, _, agg, model = load_milnet(os.path.join(tmp, "model.pth"),
                                     AGGREGATOR, 2, dev)
    infer = BagInference(emb, agg, batch_size=batch,
                         num_workers=args.num_workers, model=model)
    # warm-up: a batch through the embedder, then the aggregator twice,
    # timed (the first call is what a CLI's first bag pays)
    warm = torch.from_numpy(infer.extractor.embed_arrays(
        np.zeros((batch, 224, 224, 3), np.uint8))).to(dev)
    calls = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            agg(warm, None, ins_logits=warm[:, :2])
        sync(dev)
        calls.append(time.perf_counter() - t0)
    log(f"[infer] batch {batch}: the aggregator's first call {calls[0]:.3f} "
        f"s, its second {calls[1] * 1e3:.1f} ms (warm-up, before the runs)")

    def run(tag):
        infer.stats = HeatmapStats()
        t0 = time.perf_counter()
        results = run_attention_maps(
            infer, bag_dirs, THRESHOLDS, CLASSES,
            os.path.join(tmp, tag, "maps"),
            score_path=os.path.join(tmp, tag, "scores"), seed=0,
            log=lambda s: None)
        sync(dev)
        return results, time.perf_counter() - t0

    sync(dev)
    fused_stem.launches = fused_instance_norm.launches = 0
    results, wall = run(f"b{batch}")
    k5, k4 = fused_stem.launches, fused_instance_norm.launches
    stats = infer.stats
    batches = sum(-(-len(r.positions) // batch) for r in results)
    log(f"[infer] run_attention_maps in-process, f32, batch {batch}, "
        f"{args.num_workers} decode threads: {stats.patches} patches in "
        f"{batches} batches, wall {wall:.3f} s = {stats.patches / wall:.1f} "
        f"patches/s; {stage_split(stats)}; K5/K4 launches {k5}/{k4}; "
        f"verdicts {[r.detected for r in results]}; {gpu}")
    with profile(activities=activities(dev)) as prof:
        _, traced = run(f"b{batch}_traced")
    events = device_events(prof)
    if not events:
        log(f"[infer] batch {batch}: device busy share not measured (no "
            "device events in the trace)")
        return results
    busy = busy_us(events) / 1e6
    total, share = shares(events)
    log(f"[infer] batch {batch}: traced wall {traced:.3f} s; device busy "
        f"{busy:.3f} s = {busy / traced * 100:.1f}% of it ({busy / wall * 100:.1f}"
        f"% of the untraced wall); device time {total / 1e6:.3f} s = "
        f"{total / batches / 1e3:.3f} ms per batch: "
        + ", ".join(f"{k} {v * 100:.1f}%" for k, v in share.items())
        + f"; {gpu}")
    return results


def phase_render(tmp: str, result, side: int) -> None:
    from tpumil_torch.infer.heatmap import render_color_map, save_png

    colors = [np.asarray([0, 255, 0]), np.asarray([0, 0, 255])]
    tracemalloc.start()
    t0 = time.perf_counter()
    cmap = render_color_map(result.attention, result.positions, [0, 1],
                            colors)
    t1 = time.perf_counter()
    save_png(cmap, os.path.join(tmp, "render.png"))
    t2 = time.perf_counter()
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    log(f"[render] a {side} x {side}-tile grid -> {cmap.shape[0]} x "
        f"{cmap.shape[1]} x 3 {cmap.dtype} map of {cmap.nbytes / 2 ** 20:.1f} "
        f"MiB; render {t1 - t0:.3f} s, PNG {t2 - t1:.3f} s; host peak "
        f"{peak / 2 ** 20:.1f} MiB (tracemalloc, render and PNG, both "
        f"classes drawn)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # the compute_feats profile's slide-sized bag (PERF.md section 4)
    p.add_argument("--patches", type=int, default=4096)
    # the CLI's default batch, then the extraction default
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[64, 128])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from tpumil_torch.models import embedder
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        bag_root = os.path.join(tmp, "patches")
        t0 = time.perf_counter()
        side = write_bag(os.path.join(bag_root, "slide0"), args.patches, 224,
                         args.seed)
        log(f"[bag] {args.patches} JPEG patches of 224^2 on a {side} x {side} "
            f"tile grid, written in {time.perf_counter() - t0:.2f} s "
            f"({os.cpu_count()} threads)")
        src = embedder.init_params(args.seed, embedder.EmbedderConfig(),
                                   torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(src),
                   os.path.join(tmp, "model.pth"))
        phase_cli(tmp, bag_root, args, gpu)
        bag_dirs = [os.path.join(bag_root, "slide0")]
        phase_decode(bag_dirs[0], args)
        for batch in args.batch_sizes:
            results = phase_infer(tmp, bag_dirs, dev, batch, args, gpu)
        phase_render(tmp, results[0], side)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
