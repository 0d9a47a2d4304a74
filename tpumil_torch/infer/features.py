"""Batched feature extraction over tiled WSI patches (counterpart of
tpumil/infer/features.py).

  * one fixed batch shape through the port's ``Embedder`` on an explicit
    device; batches go over as uint8 and are divided by 255 on the device;
  * host JPEG decode runs in a prefetching thread pool (``PatchBatchLoader``)
    while the device computes, and up to two batches stay in flight: their
    host buffers are pinned (on a CUDA device) and copied without blocking,
    and their features stay on the device until popped (``launch`` starts
    one such batch; ``embed_arrays`` embeds an in-memory batch, and
    ``infer/stream_embed.py`` streams slides through ``launch``);
  * tree (multi-magnification) mode batches all high-magnification patches
    of a bag together;
  * the per-bag CSVs keep the reference's ``%.4f`` format.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from tpumil_torch.data import patches as patch_data
from tpumil_torch.data.feature_store import write_bag_csv
from tpumil_torch.models.embedder import Embedder

IN_FLIGHT = 2  # batches whose features are still on the device


@dataclasses.dataclass
class ExtractorStats:
    patches: int = 0
    seconds: float = 0.0

    @property
    def patches_per_sec(self) -> float:
        return self.patches / self.seconds if self.seconds else 0.0


class FeatureExtractor:
    """An ``Embedder`` (on its device) over fixed-size patch batches, fed by
    a prefetching host pipeline.

    ``mesh`` (the JAX package's multi-device batch sharding) is not ported:
    passing one raises NotImplementedError.
    """

    def __init__(self, model: Embedder, batch_size: int = 128,
                 patch_size: int = 224, num_workers: int = 8, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "FeatureExtractor(mesh=...) belongs to the scale-out slice "
                "(ROADMAP Queue 1), not ported yet; extract on one device")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.num_workers = num_workers
        self.stats = ExtractorStats()

    def launch(self, batch: np.ndarray):
        """Start the forward of one host batch [n, T, T, 3] (uint8, or float
        in [0, 1]). Returns its features [n, K] on the device and the host
        tensor it was copied from, which the caller keeps until the features
        are read: on a CUDA device the copy is pinned and does not block."""
        if batch.dtype != np.uint8:
            batch = batch.astype(np.float32, copy=False)
        # pin_memory needs a CUDA build and device; the CPU path copies
        # nothing
        pin = self.device.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if pin:
            host = host.pin_memory()
        with torch.inference_mode():
            feats, _ = self.model(host.to(self.device, non_blocking=pin))
        return feats, host

    def embed_arrays(self, batch: np.ndarray) -> np.ndarray:
        """Features [n, K] of a uint8 or float [n, T, T, 3] batch, computed
        on the extractor's device; uint8 crosses the bus as uint8 and is
        divided by 255 there."""
        feats, _host = self.launch(batch)
        return feats.cpu().numpy()

    def embed_paths(self, paths: Sequence[str]) -> np.ndarray:
        """Features [N, K] for a list of patch files (order preserved)."""
        if not paths:
            return np.zeros((0, self.cfg.num_feats), np.float32)
        loader = patch_data.PatchBatchLoader(
            paths, self.batch_size, self.patch_size, self.num_workers)
        outs: List[np.ndarray] = []
        pending = []  # (features on the device, n_valid, host batch)
        t0 = time.perf_counter()
        for batch, n_valid, _ in loader:
            pending.append((*self.launch(batch), n_valid))
            if len(pending) > IN_FLIGHT:
                f, _, n = pending.pop(0)
                outs.append(f[:n].cpu().numpy())
        for f, _, n in pending:
            outs.append(f[:n].cpu().numpy())
        self.stats.seconds += time.perf_counter() - t0
        self.stats.patches += len(paths)
        return np.concatenate(outs, axis=0)


def _bag_csv(save_path: str, bag_dir: str) -> str:
    """``<save_path>/<class>/<bag>.csv`` for ``.../<class>/<bag>``."""
    cls, bag = bag_dir.split(os.path.sep)[-2:]
    return os.path.join(save_path, cls, bag + ".csv")


def compute_feats(bag_dirs: Sequence[str], extractor: FeatureExtractor,
                  save_path: str, magnification: str = "single",
                  log: Callable[[str], None] = lambda s: None) -> None:
    """Single-magnification extraction: per bag, embed all patches and write
    ``<save_path>/<class>/<bag>.csv``."""
    for i, bag_dir in enumerate(bag_dirs):
        paths = patch_data.list_patches(bag_dir, magnification)
        feats = extractor.embed_paths(paths)
        if feats.shape[0] == 0:
            log(f"No valid patch extracted from: {bag_dir}\n")
            continue
        write_bag_csv(feats, _bag_csv(save_path, bag_dir))
        log(f"\r Computed: {i + 1}/{len(bag_dirs)}")
    log("\n")


def compute_tree_feats(bag_dirs: Sequence[str], extractor_low: FeatureExtractor,
                       extractor_high: FeatureExtractor, save_path: str,
                       fusion: str = "cat",
                       log: Callable[[str], None] = lambda s: None) -> None:
    """Multi-magnification extraction: embed the low-magnification patches,
    embed every high-magnification patch (batched across the bag), and
    combine each high feature with its parent low feature:
      * 'cat'    -> concat(high, low)  (1024-d for resnet18)
      * 'fusion' -> high + 0.25 * low
    """
    if fusion not in ("cat", "fusion"):
        raise NotImplementedError(
            f"{fusion} is not an accepted option for fusion. "
            "This argument accepts 2 options: 'fusion' and 'cat'.")
    for i, bag_dir in enumerate(bag_dirs):
        low_paths = patch_data.list_patches(bag_dir, "low")
        low_feats = extractor_low.embed_paths(low_paths)
        # high patches grouped by their parent low patch
        high_paths: List[str] = []
        parent_idx: List[int] = []
        for li, low_path in enumerate(low_paths):
            folder = os.path.splitext(low_path)[0]
            for ext in ("jpg", "jpeg"):
                for hp in sorted(glob.glob(os.path.join(folder, f"*.{ext}"))):
                    high_paths.append(hp)
                    parent_idx.append(li)
        if not high_paths:
            log(f"No valid patch extracted from: {bag_dir}\n")
            continue
        high_feats = extractor_high.embed_paths(high_paths)
        low_of_high = low_feats[np.asarray(parent_idx)]
        if fusion == "cat":
            tree_feats = np.concatenate([high_feats, low_of_high], axis=-1)
        else:
            tree_feats = high_feats + 0.25 * low_of_high
        write_bag_csv(tree_feats, _bag_csv(save_path, bag_dir))
        log(f"\r Computed: {i + 1}/{len(bag_dirs)}")
    log("\n")
