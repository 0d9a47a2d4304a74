"""Streaming slide -> features: tile and embed in one pass, no JPEG round
trip (counterpart of tpumil/infer/stream_embed.py).

A producer thread opens each slide, fetches its tiles on a thread pool
(one chunk of tiles in flight while the previous one is filtered),
background-filters them batched, and queues fixed-shape uint8 batches,
the last one of each slide padded with zero tiles, so the embedder always
sees one batch shape. The consumer, the caller's thread, does all the
device work: it launches each batch on the extractor's device (pinned host
copy, non-blocking H2D) and keeps up to ``IN_FLIGHT`` batches' features on
the device before it reads the oldest back. The producer touches no
tensor.

The output matches compute_feats: a per-bag feature CSV, plus a
``<name>.pos.csv`` sidecar with the ``(col, row)`` of every kept tile, so
heatmaps need no re-tiling.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tpumil_torch.data.patches import queue_put_or_stop
from tpumil_torch.data.slide import DeepZoom, magnification_plan, open_slide
from tpumil_torch.data.tiler import TilerConfig, edge_energy
from tpumil_torch.infer.features import IN_FLIGHT, FeatureExtractor


@dataclasses.dataclass
class StreamStats:
    tiles_total: int = 0
    tiles_kept: int = 0
    errors: int = 0   # tiles dropped after exhausting read retries
    seconds: float = 0.0
    # the producer's host time: tile reads summed over the fetch threads,
    # the background filter, and the resize of ragged edge tiles
    fetch_seconds: float = 0.0
    filter_seconds: float = 0.0
    resize_seconds: float = 0.0

    @property
    def slides_per_min(self) -> float:
        return 60.0 / self.seconds if self.seconds else 0.0


def _produce_one_slide(slide, dz, dz_level, cfg: TilerConfig,
                       batch_size: int, stats: StreamStats,
                       put_or_stop, stop: threading.Event) -> bool:
    """Fetch, filter and batch one slide's tiles into the consumer queue.

    Returns False if the consumer asked to stop. Emits ``(arr [batch, T, T,
    3] uint8, pos [len <= batch])`` items only; the slide's end marker is
    the caller's."""
    cols, rows = dz.level_tiles(dz_level)
    addrs = [(c, r) for r in range(rows) for c in range(cols)]
    stats.tiles_total = len(addrs)
    square_shape = (cfg.tile_size, cfg.tile_size)

    def fetch(addr):
        """Read only (the filter runs batched in the producer). A read is
        retried as the folder tiler retries it; a tile that still fails
        comes back None and is counted in stats.errors."""
        t0 = time.perf_counter()
        tile = None
        for _ in range(cfg.max_retries + 1):
            try:
                tile = dz.get_tile(dz_level, addr)
                break
            except Exception:
                continue
        return addr, tile, time.perf_counter() - t0

    def filter_chunk(items):
        """[(addr, tile)] -> kept [(addr, tile resized to tile_size^2)]."""
        from tpumil_torch.utils import native

        t0 = time.perf_counter()
        square = [(a, t) for a, t in items
                  if t is not None and t.shape[:2] == square_shape]
        ragged = [(a, t) for a, t in items
                  if t is not None and t.shape[:2] != square_shape]
        kept = []
        if square:
            if native.available():
                energies = native.edge_energy_batch(
                    np.stack([t for _, t in square]),
                    num_threads=max(1, min(cfg.workers,
                                           os.cpu_count() or 1)))
            else:
                energies = [edge_energy(t, cfg.tile_size) for _, t in square]
            kept = [(a, t) for (a, t), e in zip(square, energies)
                    if e > cfg.background_threshold]
        ragged = [(a, t) for a, t in ragged  # edge tiles: filter, then resize
                  if edge_energy(t, cfg.tile_size) > cfg.background_threshold]
        t1 = time.perf_counter()
        stats.filter_seconds += t1 - t0
        if ragged:
            from PIL import Image

            kept += [(a, np.asarray(Image.fromarray(t).resize(square_shape)))
                     for a, t in ragged]
            stats.resize_seconds += time.perf_counter() - t1
        return kept

    batch: List[np.ndarray] = []
    pos: List[Tuple[int, int]] = []

    def emit(kept) -> bool:
        nonlocal batch, pos
        for addr, tile in kept:
            batch.append(tile)  # uint8: the /255 runs on the device
            pos.append(addr)
            if len(batch) == batch_size:
                if not put_or_stop((np.stack(batch), pos)):
                    return False
                batch, pos = [], []
        return True

    # Double-buffered chunks: one chunk's reads stay in flight while the
    # previous chunk is filtered and emitted, so memory is bounded by two
    # chunks and an early stop reads no more of the slide. The pool is not
    # clamped to cpu_count (reads block on I/O and the slide's lock); only
    # the native filter's CPU-bound fan is.
    with ThreadPoolExecutor(max(1, cfg.workers)) as pool:
        chunks = [addrs[lo:lo + batch_size]
                  for lo in range(0, len(addrs), batch_size)]
        futs = [pool.submit(fetch, a) for a in chunks[0]] if chunks else []
        for ci in range(len(chunks)):
            nxt = [pool.submit(fetch, a) for a in chunks[ci + 1]] \
                if ci + 1 < len(chunks) and not stop.is_set() else []
            pending = [f.result() for f in futs]
            futs = nxt
            if stop.is_set():
                for f in futs:
                    f.cancel()
                return False
            stats.fetch_seconds += sum(dt for _, _, dt in pending)
            stats.errors += sum(1 for _, t, _ in pending if t is None)
            if not emit(filter_chunk([(a, t) for a, t, _ in pending])):
                for f in futs:
                    f.cancel()
                return False
    if batch:
        pad = np.zeros((batch_size - len(batch),) + batch[0].shape, np.uint8)
        return put_or_stop((np.concatenate([np.stack(batch), pad]), pos))
    return True


def embed_slides_streaming(slide_paths: Sequence[str],
                           extractor: FeatureExtractor,
                           mag_levels: Sequence[int] = (0,),
                           cfg: Optional[TilerConfig] = None,
                           batch_size: int = 64):
    """Stream many slides through one producer/consumer pipeline; yields
    ``(feats [N, K], positions [N, 2] (col, row), stats)`` per slide, in
    input order.

    The producer moves on to slide i+1 as soon as slide i's last batch is
    queued, so the next slide's host tiling overlaps the current slide's
    embedding tail. Single magnification only; the pyramid layout goes
    through the folder pipeline.

    A slide's ``stats.seconds`` spans its production start to its last
    features; under pipelining the spans overlap, so aggregate throughput
    comes from wall time, not from their sum.
    """
    cfg = cfg or TilerConfig()
    assert len(tuple(mag_levels)) == 1, "streaming path is single-magnification"
    slide_paths = list(slide_paths)

    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        return queue_put_or_stop(q, stop, item)

    all_stats = [StreamStats() for _ in slide_paths]
    start_times = [0.0] * len(slide_paths)

    def producer():
        try:
            for si, slide_path in enumerate(slide_paths):
                start_times[si] = time.perf_counter()
                slide = open_slide(slide_path)
                try:
                    dz = DeepZoom(slide, cfg.tile_size, cfg.overlap)
                    (dz_level, _), = magnification_plan(
                        dz, tuple(mag_levels), cfg.base_mag, cfg.objective)
                    # the fetch pool drains inside _produce_one_slide, so
                    # closing the slide here cannot race a read
                    if not _produce_one_slide(
                            slide, dz, dz_level, cfg, batch_size,
                            all_stats[si], put_or_stop, stop):
                        return
                finally:
                    slide.close()
                if not put_or_stop(("__end__", si)):
                    return
        except Exception as e:  # surface errors; never strand the consumer
            put_or_stop(e)
        finally:
            put_or_stop(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        si = 0
        pending = []  # (features on the device, n_valid, host batch)
        feats_parts: List[np.ndarray] = []
        positions: List[Tuple[int, int]] = []

        def read_back(keep: int) -> None:
            while len(pending) > keep:
                f, _host, n = pending.pop(0)
                feats_parts.append(f[:n].cpu().numpy())

        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            if isinstance(item[0], str) and item[0] == "__end__":
                _, end_si = item
                assert end_si == si, "slide markers out of order"
                read_back(0)
                stats = all_stats[si]
                stats.tiles_kept = len(positions)
                stats.seconds = time.perf_counter() - start_times[si]
                if positions:
                    out = (np.concatenate(feats_parts),
                           np.asarray(positions, int), stats)
                else:
                    out = (np.zeros((0, extractor.cfg.num_feats), np.float32),
                           np.zeros((0, 2), int), stats)
                feats_parts, positions = [], []
                si += 1
                yield out
                continue
            arr, pos = item
            pending.append((*extractor.launch(arr), len(pos)))
            positions.extend(pos)
            read_back(IN_FLIGHT)
    finally:
        stop.set()
        # the producer owns the fetch pools and slide handles: let it drain
        # before returning (a read after close is unsafe in openslide)
        t.join(timeout=60.0)


def embed_slide_streaming(slide_path: str, extractor: FeatureExtractor,
                          mag_levels: Sequence[int] = (0,),
                          cfg: Optional[TilerConfig] = None,
                          batch_size: int = 64,
                          ) -> Tuple[np.ndarray, np.ndarray, StreamStats]:
    """Tile one slide at the requested magnification and embed the kept
    tiles. Returns (feats [N, K], positions [N, 2] as (col, row), stats).

    One-slide wrapper over :func:`embed_slides_streaming`."""
    (out,) = embed_slides_streaming([slide_path], extractor, mag_levels, cfg,
                                    batch_size)
    return out


def embed_dataset_streaming(wsi_root: str, dataset: str,
                            extractor: FeatureExtractor, out_root: str,
                            cfg: Optional[TilerConfig] = None,
                            slide_format: str = "svs",
                            mag_levels: Sequence[int] = (0,),
                            batch_size: int = 64,
                            shard: Optional[Tuple[int, int]] = None,
                            log: Callable[[str], None] = print) -> Optional[str]:
    """Stream every slide of ``WSI/<dataset>/<class>/*.<fmt>`` into per-bag
    feature CSVs and the master dataset CSV. Returns the master CSV path
    (None for a shard).

    Each bag also gets a ``<name>.pos.csv`` sidecar with the (col, row) of
    every kept tile, which the folder pipeline encodes in file names; the
    feature CSV keeps the reference's format."""
    import glob

    from tpumil_torch.data.feature_store import (build_dataset_csvs,
                                                 write_bag_csv)

    cfg = cfg or TilerConfig()
    path_base = os.path.join(wsi_root, dataset)
    slides = (glob.glob(os.path.join(path_base, "*", f"*.{slide_format}"))
              + glob.glob(os.path.join(path_base, "*", "*", f"*.{slide_format}")))
    if not slides:
        raise FileNotFoundError(
            f"no *.{slide_format} slides under {path_base}/<class>/ — check "
            "--wsi_root/--dataset, and --slide_format (default 'svs')")
    slides = sorted(slides)  # deterministic order: shards must agree on it
    if shard is not None:
        i, n = shard
        slides = slides[i::n]
        log(f"shard {i}/{n}: {len(slides)} slides")
    feats_path = os.path.join(out_root, dataset)
    t_start = time.perf_counter()
    stream = embed_slides_streaming(slides, extractor, mag_levels, cfg,
                                    batch_size=batch_size)
    for i, (slide_path, (feats, positions, stats)) in \
            enumerate(zip(slides, stream)):
        rel = os.path.relpath(slide_path, path_base)
        cls = rel.split(os.sep)[0]
        name = os.path.splitext(os.path.basename(slide_path))[0]
        if stats.errors:
            log(f"WARNING {name}: {stats.errors} tiles failed to read "
                f"after {cfg.max_retries} retries and were dropped")
        if feats.shape[0] == 0:
            log(f"No valid patch extracted from: {slide_path}")
            continue
        write_bag_csv(feats, os.path.join(feats_path, cls, name + ".csv"))
        np.savetxt(os.path.join(feats_path, cls, name + ".pos.csv"),
                   positions, fmt="%d", delimiter=",", header="col,row",
                   comments="")
        wall = time.perf_counter() - t_start
        log(f"[{i + 1}/{len(slides)}] {name}: {stats.tiles_kept}/"
            f"{stats.tiles_total} tiles -> feats in {stats.seconds:.1f}s "
            f"(aggregate {60.0 * (i + 1) / wall:.2f} slides/min)")
    if shard is not None:
        log("shard done; assemble the dataset CSVs once all shards finish "
            "(tpumil_torch.data.feature_store.build_dataset_csvs / "
            "compute_feats --assemble_only)")
        return None
    return build_dataset_csvs(feats_path, dataset)
