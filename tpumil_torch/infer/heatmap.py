"""End-to-end bag inference over patch folders and attention heatmaps
(counterpart of tpumil/infer/heatmap.py).

``BagInference`` streams a bag's patches through the port's ``Embedder``
(uint8 batches from ``PatchBatchLoader``, pinned non-blocking copies, up to
two batches in flight), keeps every batch's features and instance logits on
the device, and runs the aggregator once over the whole bag. The bag is not
padded: the aggregator runs with ``mask=None`` on the ``N`` real rows, where
the JAX package pads to the power-of-two bucket under a mask; the two give
the same result.

The renders, on the host in float64:
  * ``render_color_map`` (attention_map.py): per detected class c
    ``colored += A[:, c] (x) color_c``, averaged over the detected classes;
    a benign bag renders all-zero (the reference divides by zero there).
    Then rescale_intensity to [0, 1], scatter onto the tile grid by the
    ``<a>_<b>`` file-name positions and upscale x32.
  * ``render_single_class_map`` (testing_tcga.py / testing_c16.py): one raw
    attention column rescaled to [0, 1] first, then times a unit colour.

``run_attention_maps`` is attention_map.py's loop: per bag, detect the
classes over their thresholds, render and save the PNG and optionally the
per-patch attention CSV, which ``export_scores_csv`` writes with the
standard ``csv`` module byte for byte as pandas does.
"""

from __future__ import annotations

import collections
import csv
import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpumil_torch.data import patches as patch_data
from tpumil_torch.infer.common import testing_flow_average
from tpumil_torch.infer.features import IN_FLIGHT, FeatureExtractor
from tpumil_torch.models.embedder import Embedder
from tpumil_torch.ops.image import img_as_ubyte, rescale_intensity, upscale_nearest


@dataclasses.dataclass
class BagResult:
    name: str
    scores: np.ndarray          # [C] sigmoid bag scores (after optional average)
    detected: List[int]         # classes over threshold
    attention: np.ndarray       # [N, C]
    positions: np.ndarray       # [N, 2]
    color_map: Optional[np.ndarray] = None  # [H*32, W*32, 3] float in [0,1]


@dataclasses.dataclass
class HeatmapStats:
    """Host-clock seconds per stage, summed over the bags run so far.
    ``embed_seconds`` runs from a bag's first decode until its last batch's
    outputs are ready on the device."""
    bags: int = 0
    patches: int = 0
    embed_seconds: float = 0.0
    aggregate_seconds: float = 0.0
    render_seconds: float = 0.0
    png_seconds: float = 0.0
    csv_seconds: float = 0.0


class BagInference:
    """The port's ``Embedder`` (which fixes the device) and a registry
    aggregator of model ``model`` over raw patch folders.

    ``mesh``: the patch batches' rows are split over every rank of a
    data-parallel mesh, as ``FeatureExtractor(mesh=...)`` does (rank 0 runs
    the bags, the others follow); ``batch_size`` must divide by its rank
    count. The aggregator runs once per bag on rank 0, unpadded."""

    def __init__(self, embedder: Embedder, aggregator: nn.Module,
                 batch_size: int = 64, patch_size: Optional[int] = 224,
                 num_workers: int = 8, model: str = "dsmil", mesh=None):
        from tpumil_torch.models.registry import (get_model,
                                                  require_instance_stream)

        require_instance_stream(model, "the attention map")
        if not isinstance(aggregator, get_model(model)):
            raise ValueError(f"aggregator is a {type(aggregator).__name__}, "
                             f"not a {model!r} model")
        self.extractor = FeatureExtractor(embedder, batch_size, patch_size,
                                          num_workers, mesh=mesh)
        self.aggregator = aggregator
        self.model = model
        self.stats = HeatmapStats()

    def _embed(self, paths: Sequence[str]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Features [N, K] and instance logits [N, C] of ``paths``, on the
        device, from one forward per batch."""
        ex = self.extractor
        loader = patch_data.PatchBatchLoader(paths, ex.batch_size,
                                             ex.patch_size, ex.num_workers)
        feats, logits = [], []
        in_flight = collections.deque()  # (done event or None, host batch)
        cuda = ex.device.type == "cuda"
        for batch, n_valid, _ in loader:
            f, c, host = ex.launch_with_logits(batch)
            feats.append(f[:n_valid])
            logits.append(c[:n_valid])
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            in_flight.append((done, host))
            # the host batch stays alive until its copy and forward are done
            if len(in_flight) > IN_FLIGHT:
                done, _ = in_flight.popleft()
                if done is not None:
                    done.synchronize()
        for done, _ in in_flight:
            if done is not None:
                done.synchronize()
        return torch.cat(feats), torch.cat(logits)

    def run_bag(self, bag_dir: str, patch_ext: str = "jpg",
                average: bool = False,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (bag_scores [C], attention [N, C], ins_logits [N, C],
        positions [N, 2]) for one bag of raw patches."""
        paths = patch_data.list_patches(bag_dir, "single", exts=(patch_ext,))
        if not paths:
            raise FileNotFoundError(f"no *.{patch_ext} patches in {bag_dir}")
        positions = np.asarray([patch_data.parse_position(p) for p in paths])
        t0 = time.perf_counter()
        feats, logits = self._embed(paths)
        t1 = time.perf_counter()
        with torch.inference_mode():
            _, bag_logits, attn, _ = self.aggregator(feats, None,
                                                     ins_logits=logits)
            scores = torch.sigmoid(bag_logits).cpu().numpy()
            attn, ins_logits = attn.cpu().numpy(), logits.cpu().numpy()
        if average:
            scores = testing_flow_average(scores, ins_logits)
        self.stats.bags += 1
        self.stats.patches += len(paths)
        self.stats.embed_seconds += t1 - t0
        self.stats.aggregate_seconds += time.perf_counter() - t1
        return scores, attn, ins_logits, positions


def _scatter(colored: np.ndarray, positions: np.ndarray,
             upscale: int) -> np.ndarray:
    grid = np.zeros((positions[:, 0].max() + 1, positions[:, 1].max() + 1, 3))
    for k, pos in enumerate(positions):
        grid[pos[0], pos[1]] = colored[k]
    return upscale_nearest(grid, upscale)


def render_color_map(attention: np.ndarray, positions: np.ndarray,
                     detected: Sequence[int], colors: Sequence[np.ndarray],
                     upscale: int = 32) -> np.ndarray:
    """The grid render of attention_map.py. ``colors`` are RGB in
    [0, 255]; output is float [0, 1] at tile-grid x upscale resolution."""
    n = attention.shape[0]
    colored = np.zeros((n, 3), np.float64)
    if detected:
        for c in detected:
            colored += attention[:, c:c + 1] * \
                np.asarray(colors[c], np.float64)[None, :]
        colored = rescale_intensity(colored / len(detected), (0.0, 1.0))
    return _scatter(colored, positions, upscale)


def render_single_class_map(attention_c: np.ndarray, positions: np.ndarray,
                            color01: np.ndarray, upscale: int = 32,
                            ) -> np.ndarray:
    """The testing scripts' render (testing_tcga.py, testing_c16.py): the
    raw attention column is rescaled to [0, 1] first (the least-attended
    tile goes black), then multiplied by a unit RGB colour ``color01``.
    Zeros give the black map of a benign or both-classes verdict."""
    scaled = rescale_intensity(np.asarray(attention_c, np.float64), (0.0, 1.0))
    colored = scaled[:, None] * np.asarray(color01, np.float64)[None, :]
    return _scatter(colored, positions, upscale)


def save_png(image01: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img_as_ubyte(image01)).save(path)


def export_scores_csv(attention: np.ndarray, positions: np.ndarray,
                      path: str) -> None:
    """Per-patch attention scores with a 'pos' column (attention_map.py),
    the bytes that pandas' ``DataFrame(attention)`` with a ``pos`` column
    of ``str(p)`` writes under ``to_csv(index=False)``: a header of column
    numbers and ``pos``, each value as ``str()`` of its numpy scalar (a
    float32 column gives ``0.6369617``), each position as ``str()`` of its
    numpy row (``[10  2]``)."""
    attention = np.asarray(attention)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([*range(attention.shape[1]), "pos"])
        for row, pos in zip(attention, positions):
            writer.writerow([*map(str, row), str(pos)])


def run_attention_maps(infer: BagInference, bags_list: Sequence[str],
                       thresholds: Sequence[float], class_names: Sequence[str],
                       map_path: str, colors: Optional[Sequence[np.ndarray]] = None,
                       patch_ext: str = "jpg", score_path: Optional[str] = None,
                       average: bool = False, seed: Optional[int] = None,
                       keep_maps: bool = False,
                       log: Callable[[str], None] = print) -> List[BagResult]:
    """The attention_map.py main loop: per bag, detect classes, render and
    save the heatmap, optionally export scores. Colours default to random
    RGB per class, drawn from ``np.random.default_rng(seed)`` as the JAX
    package draws them.

    ``keep_maps=False`` drops the rendered float64 map from the returned
    BagResults after saving: a 300x200-tile slide's x32 map is ~1.4 GB."""
    num_classes = len(thresholds)
    if colors is None:
        rng = np.random.default_rng(seed)
        colors = [rng.integers(0, 256, size=3) for _ in range(num_classes)]
    os.makedirs(map_path, exist_ok=True)
    stats = infer.stats
    results = []
    for bag_dir in bags_list:
        scores, attn, _, positions = infer.run_bag(bag_dir, patch_ext, average)
        scores = np.atleast_1d(np.squeeze(scores))
        detected = [c for c in range(num_classes) if scores[c] >= thresholds[c]]
        if detected:
            log(bag_dir + " is detected as: " +
                " and ".join(class_names[c] for c in detected))
        else:
            log(bag_dir + " is detected as: benign")
        t0 = time.perf_counter()
        cmap = render_color_map(attn, positions, detected, colors)
        t1 = time.perf_counter()
        slide_name = os.path.basename(bag_dir.rstrip(os.sep))
        save_png(cmap, os.path.join(map_path, slide_name + ".png"))
        t2 = time.perf_counter()
        if score_path:
            export_scores_csv(attn, positions,
                              os.path.join(score_path, slide_name + ".csv"))
        stats.render_seconds += t1 - t0
        stats.png_seconds += t2 - t1
        stats.csv_seconds += time.perf_counter() - t2
        results.append(BagResult(slide_name, scores, detected, attn, positions,
                                 cmap if keep_maps else None))
    return results
