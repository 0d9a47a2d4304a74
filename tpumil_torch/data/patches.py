"""Patch-folder datasets and a prefetching host loader (counterpart of
tpumil/data/patches.py; numpy and PIL only).

Filesystem contract (the reference's tiler output):
  WSI/<dataset>/single/<class>/<bag>/<col>_<row>.jpeg
  WSI/<dataset>/pyramid/<class>/<bag>/{<col>_<row>.jpeg, <col>_<row>/<...>.jpeg}

The loader decodes JPEGs on a host thread pool into fixed-shape NHWC uint8
batches (the /255 runs on the device: 4x fewer bytes to move), padding the
last batch with zeros, and runs a bounded number of batches ahead of the
consumer so that host decode overlaps device compute.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def list_bag_dirs(root: str, dataset: str, magnification: str) -> List[str]:
    """Bag directories under the WSI tree."""
    layout = "pyramid" if magnification in ("tree", "low", "high") else "single"
    return sorted(glob.glob(os.path.join(root, dataset, layout, "*", "*")))


def list_patches(bag_dir: str, magnification: str = "single",
                 exts: Sequence[str] = ("jpg", "jpeg")) -> List[str]:
    """Patch files of one bag: top-level files for single/low, files one
    level down for high."""
    sub = ("*",) if magnification == "high" else ()
    out: List[str] = []
    for ext in exts:
        out.extend(glob.glob(os.path.join(bag_dir, *sub, f"*.{ext}")))
    return sorted(out)


def parse_position(path: str) -> Tuple[int, int]:
    """``<a>_<b>.<ext>`` -> (a, b), the grid position the tiler encodes."""
    stem = os.path.basename(path).split(".")[0]
    a, b = stem.split("_")[:2]
    return int(a), int(b)


def decode_patch(path: str, patch_size: Optional[int] = None,
                 as_float: bool = True) -> np.ndarray:
    """JPEG/PNG -> float32 HWC in [0, 1] (torchvision ``to_tensor``
    semantics), resized (PIL bilinear) to ``patch_size`` if given.
    ``as_float=False`` keeps uint8, so that the /255 runs on the device."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if patch_size is not None and im.size != (patch_size, patch_size):
            # bilinear, as the native decode path resamples
            im = im.resize((patch_size, patch_size), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.uint8)
    return arr.astype(np.float32) / 255.0 if as_float else arr


def queue_put_or_stop(q: "queue.Queue", stop: "threading.Event", item) -> bool:
    """Enqueue without deadlocking if the consumer already left (a plain
    ``q.put`` on a full queue would pin the producer and its batches)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class PatchBatchLoader:
    """Decode a list of patch files into fixed-shape uint8 batches with
    bounded prefetch (``PREFETCH`` batches).

    Yields ``(batch [B, S, S, 3], n_valid, paths)``: the last batch is
    padded to B with zeros; ``n_valid`` counts its real rows.
    """

    PREFETCH = 4

    def __init__(self, paths: Sequence[str], batch_size: int = 128,
                 patch_size: Optional[int] = None, num_workers: int = 8):
        from tpumil_torch.utils import native

        self.paths = list(paths)
        self.batch_size = batch_size
        self.patch_size = patch_size
        # the pool blocks on file reads and PIL releases the GIL while it
        # decodes, so the configured fan is honored, not clamped to the cores
        self.num_workers = max(1, num_workers)
        # native decode needs a fixed output size and JPEG inputs
        self.use_native = (native.available() and patch_size is not None
                           and all(p.lower().endswith((".jpg", ".jpeg"))
                                   for p in self.paths))

    def __len__(self) -> int:
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        if arr.shape[0] == self.batch_size:
            return arr
        pad = np.zeros((self.batch_size - arr.shape[0],) + arr.shape[1:],
                       arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _decode_pil(self, chunk: List[str], pool) -> np.ndarray:
        return self._pad(np.stack(list(pool.map(
            lambda p: decode_patch(p, self.patch_size, as_float=False),
            chunk))))

    def _decode_native(self, chunk: List[str]) -> np.ndarray:
        from tpumil_torch.utils import native

        arr, err = native.decode_batch(chunk, self.patch_size,
                                       self.num_workers)
        # -4: a source of another size; re-decode it through PIL so that the
        # resampling is the PIL path's
        for j in np.nonzero(err == -4)[0]:
            arr[j] = decode_patch(chunk[int(j)], self.patch_size,
                                  as_float=False)
            err[j] = 0
        if np.any(err != 0):
            bad = [p for p, e in zip(chunk, err) if e != 0]
            raise IOError(f"native decode failed for {bad[:3]}")
        return self._pad(arr)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int, List[str]]]:
        if not self.paths:
            return
        chunks = [self.paths[i:i + self.batch_size]
                  for i in range(0, len(self.paths), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    try:
                        batch = (self._decode_native(chunk) if self.use_native
                                 else self._decode_pil(chunk, pool))
                    except Exception as e:  # surfaced to the consumer
                        queue_put_or_stop(q, stop, e)
                        return
                    if not queue_put_or_stop(q, stop,
                                             (batch, len(chunk), chunk)):
                        return
                queue_put_or_stop(q, stop, None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
