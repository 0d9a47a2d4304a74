"""Host-side image ops (copy of tpumil/ops/image.py): intensity rescaling,
order-0 integer upscaling and ubyte conversion for heatmaps, and the HSV
saturation of crop_single's tissue filter, in numpy, replacing the
reference's skimage calls."""

from __future__ import annotations

import numpy as np


def rescale_intensity(image: np.ndarray, out_range=(0.0, 1.0)) -> np.ndarray:
    """skimage.exposure.rescale_intensity with in_range='image'; a constant
    image comes back clipped into out_range (skimage's else-branch)."""
    image = np.asarray(image, dtype=np.float64)
    imin, imax = float(np.min(image)), float(np.max(image))
    omin, omax = float(out_range[0]), float(out_range[1])
    if imax == imin:
        return np.clip(image, omin, omax)
    scaled = (image - imin) / (imax - imin)
    return scaled * (omax - omin) + omin


def upscale_nearest(image: np.ndarray, factor: int) -> np.ndarray:
    """Order-0 resize by an integer factor."""
    return np.repeat(np.repeat(image, factor, axis=0), factor, axis=1)


def img_as_ubyte(image: np.ndarray) -> np.ndarray:
    """Float [0,1] -> uint8 (skimage rounding)."""
    return np.clip(np.rint(np.asarray(image, np.float64) * 255.0), 0,
                   255).astype(np.uint8)


def rgb_to_saturation(image: np.ndarray) -> np.ndarray:
    """The S channel of HSV for an RGB uint8/float image: S = (max - min) /
    max, 0 where max is 0 (scale invariant, so uint8 needs no rescale)."""
    img = np.asarray(image, dtype=np.float64)
    mx = img.max(axis=-1)
    mn = img.min(axis=-1)
    return np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-12), 0.0)


def mean_saturation_ubyte(image: np.ndarray) -> float:
    """Mean of the ubyte-scaled saturation channel (``img_as_ubyte(sat)``
    then mean)."""
    return float(np.mean(img_as_ubyte(rgb_to_saturation(image))))
