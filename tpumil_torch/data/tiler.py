"""WSI tiling: a DeepZoom pyramid -> background-filtered JPEG patch
folders in the reference's single/pyramid layouts (counterpart of
tpumil/data/tiler.py; host only).

Contracts kept:
  * tile file names ``<col>_<row>.<ext>``;
  * the edge-energy background filter: the mean over channel sums of a 3x3
    FIND_EDGES convolution, divided by tile_size^2, kept iff > threshold;
    non-square edge tiles are resized to tile_size before saving;
  * single layout: ``out/<class>/<slide>/<col>_<row>.jpeg``;
  * pyramid layout: low-magnification patches at the bag root, each with a
    ``<col>_<row>/`` folder of its 2^d x 2^d high-magnification children;
    low patches with no surviving children are dropped.

Tiles are fetched, filtered and saved by a thread pool; a failed read is
retried, then logged and counted.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpumil_torch.data.slide import DeepZoom, magnification_plan, open_slide


@dataclasses.dataclass
class TilerConfig:
    tile_size: int = 224          # deepzoom_tiler.py:251
    overlap: int = 0              # :246
    quality: int = 70             # :250
    background_threshold: float = 15.0  # :255
    workers: int = 4              # :249
    base_mag: float = 20.0        # :252
    objective: float = 20.0       # :254
    format: str = "jpeg"          # :247
    max_retries: int = 2
    # Encode full-size JPEG tiles with the native libjpeg writer
    # (utils/native.encode_jpeg) where it is built, else with PIL. Off by
    # default: the two encoders' bytes differ.
    native_encode: bool = False


@dataclasses.dataclass
class TileStats:
    written: int = 0
    filtered: int = 0
    errors: int = 0
    seconds: float = 0.0

    def __post_init__(self):
        import threading

        # counters are bumped from pool workers; unsynchronized += races
        self._lock = threading.Lock()

    def bump(self, field: str, delta: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + delta)

    @property
    def tiles_per_sec(self) -> float:
        total = self.written + self.filtered
        return total / self.seconds if self.seconds else 0.0


def edge_energy(tile: np.ndarray, tile_size: int) -> float:
    """The reference's background score: PIL FIND_EDGES, per-channel sums,
    mean / tile_size^2 (deepzoom_tiler.py:56-59). Uses the native filter
    (numerically equivalent, tested to rtol 1e-4) when built and the tile is
    already square at tile_size."""
    from tpumil_torch.utils import native

    if native.available() and tile.shape[:2] == (tile_size, tile_size):
        return float(native.edge_energy_batch(tile[None], num_threads=1)[0])
    from PIL import Image, ImageFilter, ImageStat

    im = Image.fromarray(tile)
    edge = im.filter(ImageFilter.FIND_EDGES)
    sums = ImageStat.Stat(edge).sum
    return float(np.mean(sums)) / (tile_size ** 2)


def _save_tile(tile: np.ndarray, path: str, cfg: TilerConfig) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if (cfg.native_encode and cfg.format in ("jpeg", "jpg")
            and tile.shape[:2] == (cfg.tile_size, cfg.tile_size)):
        from tpumil_torch.utils import native

        if native.available():
            native.encode_jpeg(tile, path, cfg.quality)
            return
    from PIL import Image

    im = Image.fromarray(tile)
    if im.size != (cfg.tile_size, cfg.tile_size):
        im = im.resize((cfg.tile_size, cfg.tile_size))
    im.save(path, quality=cfg.quality)


def _process_tile(dz: DeepZoom, dz_level: int, addr: Tuple[int, int],
                  out_path: str, cfg: TilerConfig,
                  stats: TileStats) -> bool:
    """Fetch, filter, save. Returns True iff the tile was kept."""
    for attempt in range(cfg.max_retries + 1):
        try:
            tile = dz.get_tile(dz_level, addr)
            if edge_energy(tile, cfg.tile_size) > cfg.background_threshold:
                _save_tile(tile, out_path, cfg)
                stats.bump("written")
                return True
            stats.bump("filtered")
            return False
        except Exception as e:  # retry transient read failures, then log
            if attempt == cfg.max_retries:
                stats.bump("errors")
                print(f"tile {addr} at dz level {dz_level} failed after "
                      f"{attempt + 1} attempts: {e}")
                return False
            time.sleep(0.05 * (attempt + 1))
    return False


def tile_slide(slide_path: str, out_base: str, mag_levels: Sequence[int],
               cfg: Optional[TilerConfig] = None, img_class: Optional[str] = None,
               slide_name: Optional[str] = None,
               log: Callable[[str], None] = lambda s: None) -> TileStats:
    """Tile one slide into ``out_base/<class>/<slide>/`` (single) or the
    pyramid layout (two magnifications). Returns tiling stats."""
    cfg = cfg or TilerConfig()
    mag_levels = tuple(sorted(mag_levels))
    assert len(mag_levels) <= 2, "Only 1 or 2 magnifications are supported!"
    slide = open_slide(slide_path)
    try:
        dz = DeepZoom(slide, cfg.tile_size, cfg.overlap)
        plan = magnification_plan(dz, mag_levels, cfg.base_mag, cfg.objective)
        slide_name = slide_name or os.path.splitext(os.path.basename(slide_path))[0]
        img_class = img_class or slide_path.split(os.sep)[-2]
        bag_path = os.path.join(out_base, img_class, slide_name)
        os.makedirs(bag_path, exist_ok=True)
        stats = TileStats()
        t0 = time.perf_counter()

        if len(mag_levels) == 1:
            dz_level, _ = plan[0]
            _tile_level_single(dz, dz_level, bag_path, cfg, stats, log)
        else:
            _tile_pyramid(dz, plan, mag_levels, bag_path, cfg, stats, log)
        stats.seconds = time.perf_counter() - t0
        return stats
    finally:
        slide.close()


def _tile_level_single(dz: DeepZoom, dz_level: int, bag_path: str,
                       cfg: TilerConfig, stats: TileStats,
                       log: Callable[[str], None]) -> List[Tuple[int, int]]:
    cols, rows = dz.level_tiles(dz_level)
    kept: List[Tuple[int, int]] = []
    # not clamped to cpu_count: tile workers block on file I/O and slide
    # locks, so more threads than cores still help
    with ThreadPoolExecutor(max(1, cfg.workers)) as pool:
        futures = {}
        for row in range(rows):
            for col in range(cols):
                out = os.path.join(bag_path, f"{col}_{row}.{cfg.format}")
                futures[(col, row)] = pool.submit(
                    _process_tile, dz, dz_level, (col, row), out, cfg, stats)
        for (col, row), fut in futures.items():
            if fut.result():
                kept.append((col, row))
    log(f"\r Tiled level {dz_level}: {stats.written} kept, "
        f"{stats.filtered} background")
    return kept


def _tile_pyramid(dz: DeepZoom, plan, mag_levels, bag_path: str,
                  cfg: TilerConfig, stats: TileStats,
                  log: Callable[[str], None]) -> None:
    """Two-magnification layout. Offsets are sorted ascending, so plan[0]
    (smaller offset) is the finer high-mag level (larger dz index) and
    plan[1] the coarser low-mag level."""
    (high_dz, _), (low_dz, _) = plan[0], plan[1]
    factor = 2 ** (high_dz - low_dz)
    low_kept = _tile_level_single(dz, low_dz, bag_path, cfg, stats, log)
    # high-mag children grouped under each kept low tile (the pool is not
    # clamped to cpu_count either)
    with ThreadPoolExecutor(max(1, cfg.workers)) as pool:
        for (lx, ly) in low_kept:
            sub = os.path.join(bag_path, f"{lx}_{ly}")
            futures = []
            cols, rows = dz.level_tiles(high_dz)
            for hx in range(lx * factor, (lx + 1) * factor):
                for hy in range(ly * factor, (ly + 1) * factor):
                    if hx >= cols or hy >= rows:
                        continue
                    out = os.path.join(sub, f"{hx}_{hy}.{cfg.format}")
                    futures.append(pool.submit(
                        _process_tile, dz, high_dz, (hx, hy), out, cfg, stats))
            kept_children = sum(f.result() for f in futures)
            if kept_children == 0:
                # drop childless low patches (deepzoom_tiler.py:234-238)
                low_file = os.path.join(bag_path, f"{lx}_{ly}.{cfg.format}")
                if os.path.exists(low_file):
                    os.remove(low_file)
                    stats.bump("written", -1)
                if os.path.isdir(sub):
                    try:
                        os.rmdir(sub)
                    except OSError:
                        pass


def tile_dataset(wsi_root: str, dataset: str, mag_levels: Sequence[int],
                 cfg: Optional[TilerConfig] = None, slide_format: str = "svs",
                 log: Callable[[str], None] = print) -> Dict[str, TileStats]:
    """Tile every ``WSI/<dataset>/<class>/(...)/*.<fmt>`` slide
    (deepzoom_tiler.py:259-271)."""
    import glob as _glob

    cfg = cfg or TilerConfig()
    mag_levels = tuple(sorted(mag_levels))
    path_base = os.path.join(wsi_root, dataset)
    layout = "pyramid" if len(mag_levels) == 2 else "single"
    out_base = os.path.join(wsi_root, dataset, layout)
    slides = (_glob.glob(os.path.join(path_base, "*", f"*.{slide_format}"))
              + _glob.glob(os.path.join(path_base, "*", "*", f"*.{slide_format}")))
    all_stats = {}
    for idx, slide_path in enumerate(slides):
        log(f"Process slide {idx + 1}/{len(slides)}")
        rel = os.path.relpath(slide_path, path_base)
        img_class = rel.split(os.sep)[0]
        stats = tile_slide(slide_path, out_base, mag_levels, cfg,
                           img_class=img_class, log=log)
        all_stats[slide_path] = stats
        log(f"\n{slide_path}: {stats.written} tiles kept, "
            f"{stats.filtered} background, {stats.errors} errors, "
            f"{stats.tiles_per_sec:.1f} tiles/s")
    log(f"Patch extraction done for {len(slides)} slides.")
    return all_stats
