"""Attention heatmap rendering (copy of
tpumil/infer/heatmap.py::render_color_map; the patch-folder BagInference
comes with the inference slice).

Per detected class c: ``colored += A[:, c] (x) color_c``, averaged over the
detected classes; a benign bag renders all-zero (the reference divides by
zero there). Then rescale_intensity to [0, 1], scatter onto the tile grid
and upscale x32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpumil_torch.ops.image import rescale_intensity, upscale_nearest


def render_color_map(attention: np.ndarray, positions: np.ndarray,
                     detected: Sequence[int], colors: Sequence[np.ndarray],
                     upscale: int = 32) -> np.ndarray:
    """``colors`` are RGB in [0, 255]; output is float [0, 1] at tile-grid
    x upscale resolution."""
    n = attention.shape[0]
    colored = np.zeros((n, 3), np.float64)
    if detected:
        for c in detected:
            colored += attention[:, c:c + 1] * \
                np.asarray(colors[c], np.float64)[None, :]
        colored = rescale_intensity(colored / len(detected), (0.0, 1.0))
    grid = np.zeros((positions[:, 0].max() + 1, positions[:, 1].max() + 1, 3))
    for k, pos in enumerate(positions):
        grid[pos[0], pos[1]] = colored[k]
    return upscale_nearest(grid, upscale)
