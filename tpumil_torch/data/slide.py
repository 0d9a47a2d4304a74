"""Slide readers and DeepZoom tile math (counterpart of
tpumil/data/slide.py; numpy and PIL, host only).

Four backends behind one small reader protocol:

  * OpenSlideBackend -- when the openslide library imports;
  * NativeTiffBackend -- tiled pyramidal TIFFs through the native libtiff
    service, when it is built (``utils/native.py``);
  * TiffBackend -- pyramidal (multi-page) TIFFs via PIL, each page a level;
  * ImageBackend -- any plain image as a one-level slide.

``open_slide`` tries them in that order. ``DeepZoom`` reproduces
OpenSlide's deep-zoom geometry: level 0 is 1x1, level ``level_count - 1``
is full resolution, each level halves, tiles are ``tile_size`` square with
``overlap`` extra pixels on non-edge sides. ``magnification_plan`` maps an
objective power and magnification offsets to deep-zoom levels.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_objective_power(description) -> Optional[str]:
    """Pull the scanner objective power out of an Aperio-style image
    description ("... |AppMag = 20| ..."); None when absent/unparseable.
    Shared by every TIFF-reading backend."""
    desc = str(description)
    if "AppMag" not in desc:
        return None
    try:
        return desc.split("AppMag")[1].split("=")[1].split("|")[0].strip()
    except (IndexError, ValueError):
        return None


def crop_padded(arr: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Zero-padded crop: out-of-bounds parts of the requested window come
    back black, like openslide's read_region. Shared by the full-array
    backends."""
    out = np.zeros((h, w, 3), np.uint8)
    ys, xs = max(0, y), max(0, x)
    ye, xe = min(arr.shape[0], y + h), min(arr.shape[1], x + w)
    if ye > ys and xe > xs:
        out[ys - y:ye - y, xs - x:xe - x] = arr[ys:ye, xs:xe]
    return out


class SlideBackend:
    """Protocol: level_dimensions[0] is full resolution; read_region takes a
    level-0 coordinate, a level index, and a (w, h) size in level pixels."""

    level_dimensions: List[Tuple[int, int]]
    properties: Dict[str, str]

    @property
    def level_count(self) -> int:
        return len(self.level_dimensions)

    def level_downsample(self, level: int) -> float:
        w0, h0 = self.level_dimensions[0]
        w, h = self.level_dimensions[level]
        return ((w0 / w) + (h0 / h)) / 2.0

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        raise NotImplementedError

    def best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for lv in range(self.level_count):
            if self.level_downsample(lv) <= downsample + 1e-6:
                best = lv
        return best

    def objective_power(self, fallback: float) -> float:
        v = self.properties.get("openslide.objective-power")
        return float(v) if v else float(fallback)

    def close(self):
        pass


class OpenSlideBackend(SlideBackend):
    def __init__(self, path: str):
        import openslide

        self._slide = openslide.OpenSlide(path)
        self.level_dimensions = list(self._slide.level_dimensions)
        self.properties = dict(self._slide.properties)

    def read_region(self, location, level, size):
        img = self._slide.read_region(location, level, size)
        return np.asarray(img.convert("RGB"))

    def close(self):
        self._slide.close()


class TiffBackend(SlideBackend):
    """Pyramidal TIFF via PIL: pages sorted by area descending become levels.
    Custom tags: objective power from tag 270 (ImageDescription) if it
    contains ``AppMag = N`` (Aperio convention)."""

    def __init__(self, path: str):
        import threading

        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        self._lock = threading.Lock()
        self._im = Image.open(path)
        self._pages: List[int] = []
        sizes = []
        i = 0
        while True:
            try:
                self._im.seek(i)
            except EOFError:
                break
            sizes.append((i, self._im.size))
            i += 1
        sizes.sort(key=lambda t: t[1][0] * t[1][1], reverse=True)
        self._pages = [i for i, _ in sizes]
        self.level_dimensions = [s for _, s in sizes]
        self.properties = {}
        self._im.seek(self._pages[0])
        desc = self._im.tag_v2.get(270, "") if hasattr(self._im, "tag_v2") else ""
        if isinstance(desc, tuple):
            desc = desc[0] if desc else ""
        mag = parse_objective_power(desc)
        if mag is not None:
            self.properties["openslide.objective-power"] = mag
        # cache decoded pages lazily (fine for the PIL fallback; the native
        # libtiff service streams tiles without full decode). Byte-capped:
        # a stripped gigapixel slide would otherwise pin every decoded
        # level in memory at once — beyond the cap only the page being
        # read is kept (memory bounded by the largest single page).
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_cap = 512 << 20

    def _page_array(self, level: int) -> np.ndarray:
        with self._lock:  # PIL seek/decode is not thread-safe
            if level not in self._cache:
                self._im.seek(self._pages[level])
                arr = np.asarray(self._im.convert("RGB"))
                while self._cache and (sum(a.nbytes for a in
                                           self._cache.values())
                                       + arr.nbytes) > self._cache_cap:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[level] = arr
            return self._cache[level]

    def read_region(self, location, level, size):
        arr = self._page_array(level)
        ds = self.level_downsample(level)
        return crop_padded(arr, int(location[0] / ds), int(location[1] / ds),
                           size[0], size[1])

    def close(self):
        with self._lock:  # never close mid-decode of a pool worker
            self._im.close()


class ImageBackend(SlideBackend):
    """A plain image as a one-level slide (ImageSlide equivalent,
    deepzoom_tiler.py:72)."""

    def __init__(self, path_or_array):
        if isinstance(path_or_array, np.ndarray):
            self._arr = path_or_array
        else:
            from PIL import Image

            Image.MAX_IMAGE_PIXELS = None
            with Image.open(path_or_array) as im:
                self._arr = np.asarray(im.convert("RGB"))
        h, w = self._arr.shape[:2]
        self.level_dimensions = [(w, h)]
        self.properties = {}

    def read_region(self, location, level, size):
        return crop_padded(self._arr, location[0], location[1],
                           size[0], size[1])


class NativeTiffBackend(SlideBackend):
    """libtiff-backed reader (native/tileservice.cc): true tiled reads, no
    full-page decode — the production path for gigapixel slides when
    openslide is unavailable."""

    def __init__(self, path: str):
        from tpumil_torch.utils.native import NativeTiff

        self._tif = NativeTiff(path)
        if not self._tif.is_tiled:
            # stripped layout: libtiff must decode the whole page per region
            # read (measured 0.14 s/tile on a 6k² slide) — the caching PIL
            # backend is the right engine for those; real scanner files are
            # tiled and stay on this path
            self._tif.close()
            raise IOError(f"{path} is a stripped TIFF; use TiffBackend")
        self.level_dimensions = list(self._tif.level_dimensions)
        self.properties = {}
        mag = parse_objective_power(self._tif.description)
        if mag is not None:
            self.properties["openslide.objective-power"] = mag

    def read_region(self, location, level, size):
        ds = self.level_downsample(level)
        return self._tif.read_region(level, int(location[0] / ds),
                                     int(location[1] / ds), size[0], size[1])

    def close(self):
        self._tif.close()


def open_slide(path: str) -> SlideBackend:
    """Backend auto-selection: openslide when available, then the native
    libtiff service, then PIL-TIFF, then plain image. Openslide failures on
    formats it cannot parse (plain TIFFs, PNGs, broken installs) fall through
    to the other backends instead of aborting the run."""
    ext = os.path.splitext(path)[1].lower()
    try:
        import openslide  # noqa: F401

        return OpenSlideBackend(path)
    except ImportError:
        pass
    except Exception:
        # openslide present but cannot open this file (e.g.
        # OpenSlideUnsupportedFormatError) — try the other backends
        pass
    if ext in (".tif", ".tiff", ".svs"):
        from tpumil_torch.utils import native

        if native.available():
            try:
                return NativeTiffBackend(path)
            except (IOError, OSError):
                pass  # unsupported compression etc. -> PIL fallback
        return TiffBackend(path)
    return ImageBackend(path)


# ---------------------------------------------------------------------------
# DeepZoom geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeepZoom:
    """OpenSlide-compatible deep-zoom pyramid over a SlideBackend."""

    slide: SlideBackend
    tile_size: int = 224
    overlap: int = 0

    def __post_init__(self):
        w, h = self.slide.level_dimensions[0]
        levels = [(w, h)]
        while max(w, h) > 1:
            w = max(1, (w + 1) // 2)
            h = max(1, (h + 1) // 2)
            levels.append((w, h))
        levels.reverse()  # level 0 = 1x1
        self.level_dimensions_dz = levels

    @property
    def level_count(self) -> int:
        return len(self.level_dimensions_dz)

    def level_tiles(self, dz_level: int) -> Tuple[int, int]:
        w, h = self.level_dimensions_dz[dz_level]
        return (math.ceil(w / self.tile_size), math.ceil(h / self.tile_size))

    def _tile_bounds(self, dz_level: int, col: int, row: int):
        """Tile geometry in dz-level pixels: (x, y, w, h) including overlap."""
        lw, lh = self.level_dimensions_dz[dz_level]
        x = col * self.tile_size - (self.overlap if col > 0 else 0)
        y = row * self.tile_size - (self.overlap if row > 0 else 0)
        cols, rows = self.level_tiles(dz_level)
        w = self.tile_size + (self.overlap if col > 0 else 0) \
            + (self.overlap if col < cols - 1 else 0)
        h = self.tile_size + (self.overlap if row > 0 else 0) \
            + (self.overlap if row < rows - 1 else 0)
        w = min(w, lw - x)
        h = min(h, lh - y)
        return x, y, w, h

    def get_tile(self, dz_level: int, address: Tuple[int, int]) -> np.ndarray:
        col, row = address
        x, y, w, h = self._tile_bounds(dz_level, col, row)
        dz_downsample = 2 ** (self.level_count - 1 - dz_level)
        slide_level = self.slide.best_level_for_downsample(dz_downsample)
        ds = self.slide.level_downsample(slide_level)
        # region in slide-level pixels: ceil the size and clamp to the level
        # bounds, matching openslide.deepzoom's l_size math (size up, never
        # past the level edge)
        scale = dz_downsample / ds
        lw_l, lh_l = self.slide.level_dimensions[slide_level]
        lx, ly = x * scale, y * scale
        sw = max(1, min(math.ceil(scale * w), lw_l - math.ceil(lx)))
        sh = max(1, min(math.ceil(scale * h), lh_l - math.ceil(ly)))
        # level-0 location in exact integer math (x * 2^k): routing it through
        # lx*ds would re-truncate a 239.999... float on non-power-of-two level
        # downsamples and shift the read by a pixel
        region = self.slide.read_region(
            (int(x * dz_downsample), int(y * dz_downsample)), slide_level,
            (sw, sh))
        if (sw, sh) != (w, h):
            from PIL import Image

            region = np.asarray(
                Image.fromarray(region).resize((w, h), Image.LANCZOS))
        return region


def magnification_plan(dz: DeepZoom, mag_levels: Tuple[int, ...], base_mag: float,
                       objective: float) -> List[Tuple[int, int]]:
    """Map requested magnification offsets to deep-zoom levels
    (deepzoom_tiler.py:163-168 + :95-97). Returns [(dz_level, magnification)]
    ordered by ascending offset — plan[0] is the HIGHEST magnification
    (largest dz level); _tile_pyramid unpacks it as high_dz.

    mag_levels: offsets below base_mag, e.g. (0,) = base only, (0, 2) =
    base and base/4 (two pyramid levels apart).
    """
    mag_base = dz.slide.objective_power(objective)
    if mag_base < base_mag:
        raise ValueError(
            f"slide objective power {mag_base}x is below the requested "
            f"base magnification {base_mag}x — lower --base_mag (the "
            f"reference would compute a negative level here and crash, "
            f"deepzoom_tiler.py:166)")
    # int() truncation (not round) mirrors deepzoom_tiler.py:166 exactly:
    # a 30x slide with base_mag=20 truncates to first_level 0 (tiled at
    # 30x) just like the reference
    first_level = int(math.log2(mag_base / base_mag))
    offsets = sorted(mag_levels)
    plan = []
    for off in offsets:
        lvl_below_top = off + first_level
        dz_level = dz.level_count - 1 - lvl_below_top
        mag = int(mag_base / (2 ** lvl_below_top))
        plan.append((dz_level, mag))
    return plan
