"""Where the time goes in the one-pass slide -> features path on the card:
``tpumil_torch``'s slide_feats on one synthetic slide of scanner size.

    python -m tools.stream_profile               # on a CUDA card
    python -m tools.stream_profile --device cpu --side 896 --tile_size 64 \\
        --batch_size 4                           # a quick CPU dry run

Phases (each prints its own lines):
  1. slide   -- one ``--side``^2 RGB slide at 20x (``--side`` 11200: 50 x 50
                = 2500 tiles of 224^2), white glass with one textured tissue
                ellipse over 40% of its area, as a 3-level pyramid with an
                Aperio ``AppMag = 20`` description. Written as a tiled JPEG
                pyramid by the native tile service when it is built (run
                ``make -C native`` first; this tool builds nothing), else as
                a stripped PIL TIFF; the lines say which, with the slide's
                size, the reader and filter the stream takes, and the time
                of the reader's first read.
  2. cli     -- ``python -m tpumil_torch.cli.slide_feats`` as a subprocess:
                its wall, tiles/s and slides/min, start-up included.
  3. host    -- the producer alone (read, filter, batch; batches dropped):
                the host's tile rate without the device.
  4. stream  -- ``embed_slide_streaming`` in-process after a warm-up batch:
                tiles/s, slides/min, and the producer's time split between
                tile reads (summed over the fetch threads), the background
                filter and the resize of ragged edge tiles.
  5. trace   -- the same run under ``torch.profiler``: the device's busy
                share of the wall (the union of kernel, copy and memset
                intervals), its time per batch and each kernel class's share.

Device numbers come from the profiler's chrome trace; when it holds no
device event (as on the CPU), the device lines say "not measured".
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import profile

from tools.extract_profile import shares
from tools.serve_profile import (activities, busy_us, device_events, gpu_line,
                                 log, sync)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "synth"
DESCRIPTION = "Aperio Fake |AppMag = 20|"
BAND = 1024  # rows synthesized at a time
TISSUE = 0.4  # share of the slide's area under tissue
SEED = 0
WORKERS = 4  # fetch threads, slide_feats' default
PRECISION = "f32"  # slide_feats' default


def synth_slide(side: int, tissue: float, seed: int) -> np.ndarray:
    """[side, side, 3] uint8: white glass with one centred tissue ellipse
    (axes 5:4) over ``tissue`` of the area, textured as a smooth colour
    field plus per-pixel noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(20, 220, (max(2, side // 64), max(2, side // 64), 3),
                          np.uint8)
    field = np.asarray(Image.fromarray(coarse).resize((side, side),
                                                      Image.BICUBIC))
    b = side * np.sqrt(tissue / (np.pi * 1.25))
    a = 1.25 * b
    c = (side - 1) / 2.0
    img = np.full((side, side, 3), 255, np.uint8)
    xx = ((np.arange(side) - c) / a) ** 2
    for lo in range(0, side, BAND):
        yy = ((np.arange(lo, min(side, lo + BAND)) - c) / b) ** 2
        inside = (yy[:, None] + xx[None, :]) <= 1.0
        noisy = np.clip(field[lo:lo + BAND].astype(np.int16)
                        + rng.integers(-20, 21, field[lo:lo + BAND].shape,
                                       dtype=np.int16), 0, 255)
        img[lo:lo + BAND][inside] = noisy[inside].astype(np.uint8)
    return img


def write_slide(path: str, img: np.ndarray, tiled: bool,
                levels: int = 3) -> None:
    """A ``levels``-level pyramid with the Aperio 20x description: tiled
    JPEG through the native service, or stripped raw pages through PIL,
    each level half the one above."""
    from PIL import Image

    from tpumil_torch.utils import native

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if tiled:
        native.write_tiled_pyramid(path, img, tile=256, levels=levels,
                                   quality=90, description=DESCRIPTION)
        return
    Image.MAX_IMAGE_PIXELS = None
    pages = [Image.fromarray(img)]
    for _ in range(levels - 1):
        prev = pages[-1]
        pages.append(prev.resize((max(1, prev.width // 2),
                                  max(1, prev.height // 2))))
    pages[0].save(path, save_all=True, append_images=pages[1:],
                  description=DESCRIPTION)


def phase_slide(tmp: str, args):
    from tpumil_torch.utils import native

    tiled = native.can_write_pyramid()
    path = os.path.join(tmp, "WSI", DATASET, "tumor", "slide0.tif")
    t0 = time.perf_counter()
    img = synth_slide(args.side, TISSUE, SEED)
    write_slide(path, img, tiled)
    cols = -(-args.side // args.tile_size)
    log(f"[slide] {args.side}x{args.side} at 20x ({cols * cols} tiles of "
        f"{args.tile_size}^2, tissue {TISSUE:.0%} of the area), "
        f"{'a tiled JPEG pyramid (native writer)' if tiled else 'a stripped PIL TIFF'}"
        f", 3 levels, {os.path.getsize(path) / 2 ** 20:.1f} MiB on disk, "
        f"written in {time.perf_counter() - t0:.2f} s; native tile service "
        f"{'available' if native.available() else 'not built'}")
    return path


def backend_line(path: str) -> str:
    """The reader and filter the stream will take, and the time of a first
    one-pixel read (a stripped reader decodes its whole page there)."""
    from tpumil_torch.data.slide import open_slide
    from tpumil_torch.utils import native

    t0 = time.perf_counter()
    slide = open_slide(path)
    slide.read_region((0, 0), 0, (1, 1))
    first = time.perf_counter() - t0
    name = type(slide).__name__
    slide.close()
    return (f"reader {name}, edge filter "
            f"{'native' if native.available() else 'PIL'}; open and first "
            f"read {first:.3f} s")


def phase_cli(tmp: str, args, gpu: str) -> None:
    cmd = [sys.executable, "-m", "tpumil_torch.cli.slide_feats",
           "--device", args.device, "--dataset", DATASET,
           "--slide_format", "tif", "--weights", "model.pth",
           "--precision", PRECISION,
           "--tile_size", str(args.tile_size),
           "--batch_size", str(args.batch_size),
           "--workers", str(WORKERS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          timeout=1800, env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"slide_feats exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("[1/1]")]
    tiles = int(line.split(": ")[1].split("/")[1].split()[0])
    log(f"[cli] {' '.join(cmd[1:])}: exit 0 in {wall:.2f} s (start-up "
        f"included) = {tiles / wall:.1f} tiles/s, {60.0 / wall:.3f} "
        f"slides/min; it printed: {line.strip()}; {gpu}")


def phase_host(path: str, cfg, args) -> None:
    from tpumil_torch.data.slide import DeepZoom, magnification_plan, open_slide
    from tpumil_torch.infer.stream_embed import StreamStats, _produce_one_slide

    stats, batches = StreamStats(), []
    t0 = time.perf_counter()
    slide = open_slide(path)
    try:
        dz = DeepZoom(slide, cfg.tile_size, cfg.overlap)
        (level, _), = magnification_plan(dz, (0,), cfg.base_mag, cfg.objective)
        _produce_one_slide(slide, dz, level, cfg, args.batch_size, stats,
                           lambda item: batches.append(len(item[1])) or True,
                           threading.Event())
    finally:
        slide.close()
    wall = time.perf_counter() - t0
    log(f"[host] the producer alone ({cfg.workers} fetch threads, "
        f"{os.cpu_count()} cores): {stats.tiles_total} tiles read, "
        f"{sum(batches)} kept in {len(batches)} batches, in {wall:.3f} s = "
        f"{stats.tiles_total / wall:.1f} tiles/s; reads "
        f"{stats.fetch_seconds:.3f} s over the threads, filter "
        f"{stats.filter_seconds:.3f} s, resize {stats.resize_seconds:.3f} s")


def phase_stream(tmp: str, path: str, cfg, dev: torch.device, args,
                 gpu: str) -> None:
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.stream_embed import embed_slide_streaming
    from tpumil_torch.models import embedder

    model = embedder.load_simclr_checkpoint(
        os.path.join(tmp, "model.pth"), embedder.EmbedderConfig(
            num_classes=1, precision=PRECISION, space_to_depth=True), dev)
    ex = FeatureExtractor(model, args.batch_size, args.tile_size)
    ex.embed_arrays(np.zeros((args.batch_size, args.tile_size,
                              args.tile_size, 3), np.uint8))  # warm-up
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        feats, _, stats = embed_slide_streaming(path, ex, (0,), cfg,
                                                args.batch_size)
        sync(dev)
        walls.append(time.perf_counter() - t0)
        batches = -(-stats.tiles_kept // args.batch_size)
        log(f"[stream] embed_slide_streaming in-process, {PRECISION}, "
            f"batch {args.batch_size}: {stats.tiles_kept}/{stats.tiles_total} "
            f"tiles kept ({batches} batches) in {walls[-1]:.3f} s = "
            f"{stats.tiles_total / walls[-1]:.1f} tiles/s read, "
            f"{stats.tiles_kept / walls[-1]:.1f} kept tiles/s, "
            f"{60.0 / walls[-1]:.3f} slides/min; producer: reads "
            f"{stats.fetch_seconds:.3f} s over {cfg.workers} threads, filter "
            f"{stats.filter_seconds:.3f} s, resize {stats.resize_seconds:.3f} "
            f"s; {gpu}")
    if feats.shape != (stats.tiles_kept, 512) or not np.isfinite(feats).all():
        raise AssertionError(f"bad features {feats.shape}")
    with profile(activities=activities(dev)) as prof:
        t0 = time.perf_counter()
        embed_slide_streaming(path, ex, (0,), cfg, args.batch_size)
        sync(dev)
        traced = time.perf_counter() - t0
    events = device_events(prof)
    if not events:
        log("[trace] device busy share: not measured (no device events in "
            "the trace)")
        return
    busy = busy_us(events) / 1e6
    total, share = shares(events)
    log(f"[trace] traced wall {traced:.3f} s; device busy {busy:.3f} s = "
        f"{busy / traced * 100:.1f}% of it ({busy / min(walls) * 100:.1f}% "
        f"of the untraced wall); device time {total / 1e6:.3f} s = "
        f"{total / batches / 1e3:.3f} ms per batch: "
        + ", ".join(f"{k} {v * 100:.1f}%" for k, v in share.items())
        + f"; {gpu}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # a 20x scanner slide is ~40k x 30k; 11200^2 keeps one slide's
    # stripped pages under TiffBackend's 512 MB page cache
    p.add_argument("--side", type=int, default=11200)
    p.add_argument("--tile_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=128)
    args = p.parse_args(argv)
    from tpumil_torch.data.tiler import TilerConfig
    from tpumil_torch.models import embedder
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    cfg = TilerConfig(tile_size=args.tile_size, workers=WORKERS)
    with tempfile.TemporaryDirectory() as tmp:
        path = phase_slide(tmp, args)
        log(f"[slide] {backend_line(path)}")
        src = embedder.init_params(SEED, embedder.EmbedderConfig(),
                                   torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(src),
                   os.path.join(tmp, "model.pth"))
        phase_cli(tmp, args, gpu)
        phase_host(path, cfg, args)
        phase_stream(tmp, path, cfg, dev, args, gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
