"""Inference serving: cross-request micro-batching onto one fixed batch
shape (counterpart of tpumil/infer/service.py).

    client A (3 patches)  \\
    client B (5 patches)   >  one [batch_size, P, P, 3] device forward
    client C (120 rows)   /

The embedder always runs at ``batch_size`` rows, so the per-launch cost is
amortized over concurrent clients. Rows are batch-dim independent (instance
norm normalizes per sample, batch norm runs folded statistics), and the
batch shape never changes, so a row's features do not depend on which
requests it shared a batch with. Bags aggregate unpadded: the power-of-two
buckets of the JAX package exist for XLA's static shapes.

With a data-parallel ``mesh`` each batch's rows are split over every rank
of the process group (``parallel/mesh.BatchShardedForward``): rank 0 serves,
the other ranks follow. After the warm-up, only the batcher's worker thread
runs the collectives: the batches, a keep-alive header while idle, and "stop"
when the service closes.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpumil_torch.models.embedder import Embedder


@dataclasses.dataclass
class ServiceStats:
    """Serving counters (all monotonic). requests/patches increment under
    the batcher's submit lock, batches/batch_rows/errors only from the one
    worker thread. Reads skip locking: torn reads of monitoring counters
    are harmless."""
    requests: int = 0
    patches: int = 0
    batches: int = 0
    batch_rows: int = 0            # real (non-pad) rows dispatched
    errors: int = 0

    @property
    def fill_ratio(self) -> float:
        """Mean number of real rows per dispatched batch."""
        return (self.batch_rows / self.batches) if self.batches else 0.0

    def as_dict(self, batch_size: int) -> Dict[str, float]:
        return {
            "requests": self.requests,
            "patches": self.patches,
            "batches": self.batches,
            "errors": self.errors,
            "mean_batch_fill": round(self.fill_ratio / batch_size, 4)
            if self.batches else 0.0,
        }


# fixed serving palette (the reference draws random colors per run; a
# serving endpoint must be deterministic)
_DEFAULT_PALETTE = np.asarray(
    [[220, 40, 40], [40, 180, 60], [50, 90, 230], [230, 180, 30],
     [170, 60, 200], [40, 200, 200], [240, 120, 40], [130, 130, 130]],
    np.float64)


class _Request:
    """One submit()'s result buffer; chunks from the batcher fill it."""

    __slots__ = ("out", "_remaining", "_event", "error", "_lock")

    def __init__(self, n_rows: int, width: int):
        self.out = np.empty((n_rows, width), np.float32)
        self._remaining = n_rows
        self._event = threading.Event()
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _complete_rows(self, n: int) -> None:
        with self._lock:
            self._remaining -= n
            if self._remaining <= 0:
                self._event.set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            self.error = exc
            self._event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.out


class MicroBatcher:
    """Packs concurrent variable-size requests into fixed-size batches.

    ``fwd`` maps a uint8 ``[batch_size, P, P, 3]`` array to a float32
    ``[batch_size, width]`` array. A partial batch is flushed ``max_wait_ms``
    after its first row arrived; pad rows are zeros and their outputs are
    dropped. ``fwd`` runs on the worker thread under ``torch.inference_mode``
    (grad mode is thread-local, so the worker enters it itself), and so do
    ``idle()``, called while no request waits, and ``finish()``, called
    once as the worker exits.
    """

    def __init__(self, fwd, batch_size: int, patch_size: int,
                 out_width: int, max_wait_ms: float = 8.0,
                 queue_limit: int = 256, idle=None, finish=None):
        self._fwd = fwd
        self._idle = idle
        self._finish = finish
        self.batch_size = int(batch_size)
        self.patch_size = int(patch_size)
        self.out_width = int(out_width)
        self.max_wait_s = max_wait_ms / 1e3
        # queue items: (request, images[n, P, P, 3] uint8, dst_row_start)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self.stats = ServiceStats()
        self._stop = threading.Event()
        # Orders submit against close: a submit that passed the closed check
        # fully enqueues BEFORE stop is set, so the worker's stop+empty exit
        # condition never strands its rows. Also serializes the stats `+=`.
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpumil-microbatcher")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, images: np.ndarray) -> _Request:
        """Enqueue ``[N, P, P, 3]`` uint8 images; ``.result()`` of the
        returned request is ``[N, out_width]`` float32 in row order."""
        images = np.ascontiguousarray(images)
        if images.ndim != 4 or images.shape[1:] != (self.patch_size,
                                                    self.patch_size, 3):
            raise ValueError(
                f"expected [N, {self.patch_size}, {self.patch_size}, 3], "
                f"got {images.shape}")
        if images.dtype != np.uint8:
            raise ValueError(f"expected uint8 images, got {images.dtype} "
                             "(scale to [0, 255] on the client)")
        req = _Request(images.shape[0], self.out_width)
        if images.shape[0] == 0:
            req._event.set()
            return req
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self.stats.requests += 1
            self.stats.patches += images.shape[0]
            # split oversize requests into chunks the packer can interleave
            for start in range(0, images.shape[0], self.batch_size):
                chunk = images[start:start + self.batch_size]
                self._q.put((req, chunk, start))
        return req

    def close(self) -> None:
        with self._submit_lock:  # waits out any in-flight submit
            self._stop.set()
        self._worker.join(timeout=5.0)

    # -- worker side --------------------------------------------------------

    def _run(self) -> None:
        with torch.inference_mode():
            try:
                self._loop()
            finally:
                if self._finish is not None:
                    self._finish()

    def _loop(self) -> None:
        B, P = self.batch_size, self.patch_size
        buf = np.zeros((B, P, P, 3), np.uint8)
        carry = None  # oversize-chunk remainder; leads the next batch
        while not (self._stop.is_set() and carry is None
                   and self._q.empty()):
            entries: List = []     # (request, src_start, dst_start, n)
            rows = 0
            deadline = None
            # pack until full or the first row's deadline passes
            while rows < B:
                if carry is not None:
                    req, chunk, src_start = carry
                    carry = None
                else:
                    timeout = 0.05 if deadline is None \
                        else max(deadline - time.monotonic(), 0.0)
                    try:
                        req, chunk, src_start = self._q.get(timeout=timeout)
                    except queue.Empty:
                        if rows and deadline is not None \
                                and time.monotonic() >= deadline:
                            break
                        if self._stop.is_set():
                            break
                        if not rows and self._idle is not None:
                            self._idle()
                        continue
                if deadline is None:
                    deadline = time.monotonic() + self.max_wait_s
                take = min(len(chunk), B - rows)
                buf[rows:rows + take] = chunk[:take]
                entries.append((req, src_start, rows, take))
                if take < len(chunk):
                    carry = (req, chunk[take:], src_start + take)
                rows += take
            if not rows:
                continue
            if rows < B:
                buf[rows:] = 0  # stale rows from the previous batch
            try:
                out = np.asarray(self._fwd(buf))
            except Exception as exc:  # noqa: BLE001 - must not kill the loop
                self.stats.errors += 1
                for req, _, _, _ in entries:
                    req._fail(exc)
                continue
            self.stats.batches += 1
            self.stats.batch_rows += rows
            for req, src_start, dst_start, n in entries:
                req.out[src_start:src_start + n] = out[dst_start:dst_start + n]
                req._complete_rows(n)


class InferenceService:
    """Embedder (+ optional aggregator of any registry model) behind a
    micro-batching queue.

    ``embed`` / ``predict`` / ``predict_patches`` / ``heatmap`` are
    thread-safe; embedding work from all callers shares one fixed-shape
    device forward on ``device``.

    ``mesh``: a data-parallel mesh over the process group; ``batch_size``
    must divide by its rank count. On rank 0 the service serves as without
    one, each batch's rows split over the ranks; on every other rank it
    only builds the forward, and ``parallel/mesh.follow`` then serves rank
    0's batches until rank 0's ``close()``. A row's features stay bitwise
    independent of request packing.
    """

    # seconds an idle sharded service waits before it sends the followers a
    # keep-alive header: well inside the process group's timeout
    KEEPALIVE_S = 60.0

    def __init__(self, embedder: Embedder, device: torch.device,
                 aggregator: Optional[torch.nn.Module] = None, model: str = "dsmil",
                 batch_size: int = 128, patch_size: int = 224,
                 max_wait_ms: float = 8.0,
                 thresholds: Optional[Sequence[float]] = None,
                 average: bool = False, queue_limit: int = 256, mesh=None):
        if aggregator is not None:
            from tpumil_torch.models.registry import require_instance_stream

            require_instance_stream(model, "the inference service")
        self.embedder = embedder
        self.device = device
        self.aggregator = aggregator
        self.model = model
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.thresholds = None if thresholds is None else np.asarray(
            thresholds, np.float32)
        self.average = average
        self.num_feats = embedder.cfg.num_feats
        self.num_classes = embedder.cfg.num_classes
        width = self.num_feats + self.num_classes
        emb, idle, finish = embedder, None, None
        if mesh is not None:
            from tpumil_torch.parallel import mesh as pmesh

            # kept here: the follower loop holds its forwards weakly
            self._sharded = emb = pmesh.BatchShardedForward(
                mesh, batch_size, embedder, device)
            if not pmesh.is_main():
                self._batcher = None  # a follower: parallel/mesh.follow
                return
            idle = functools.partial(pmesh.keepalive, self.KEEPALIVE_S)
            finish = pmesh.stop_followers

        def fwd(imgs: np.ndarray) -> np.ndarray:
            # uint8 crosses the bus; embedder divides by 255 on the device
            feats, logits = emb(torch.from_numpy(imgs).to(device))
            # one [B, K+C] device->host copy
            return torch.cat([feats, logits.float()], dim=-1).cpu().numpy()

        # warm up (cuDNN plans, kernel build) before accepting traffic
        with torch.inference_mode():
            fwd(np.zeros((batch_size, patch_size, patch_size, 3), np.uint8))
        self._batcher = MicroBatcher(fwd, batch_size, patch_size, width,
                                     max_wait_ms, queue_limit, idle, finish)

    # -- embedding ----------------------------------------------------------

    def embed(self, images: np.ndarray,
              timeout: Optional[float] = 120.0) -> np.ndarray:
        """Features ``[N, K]`` for ``[N, P, P, 3]`` uint8 images."""
        out = self._batcher.submit(images).result(timeout)
        return out[:, :self.num_feats]

    def embed_with_logits(self, images: np.ndarray,
                          timeout: Optional[float] = 120.0):
        out = self._batcher.submit(images).result(timeout)
        return out[:, :self.num_feats], out[:, self.num_feats:]

    # -- aggregation --------------------------------------------------------

    def predict(self, feats: np.ndarray,
                ins_logits: Optional[np.ndarray] = None) -> Dict:
        """Bag prediction from features ``[N, K]`` (optionally with
        precomputed instance logits, as the reference inference scripts do).
        Returns scores/detected/attention/ins_logits as numpy/python."""
        if self.aggregator is None:
            raise RuntimeError("service started without aggregator weights")
        feats = np.array(feats, np.float32)  # writable copy of a wire view
        if feats.ndim != 2 or feats.shape[1] != self.num_feats:
            raise ValueError(f"expected [N, {self.num_feats}] features, "
                             f"got {feats.shape}")
        if feats.shape[0] == 0:
            raise ValueError("empty bag (0 instances) cannot be aggregated")
        from tpumil_torch.infer.common import testing_flow_average

        with torch.inference_mode():
            f = torch.from_numpy(feats).to(self.device)
            c = None if ins_logits is None else torch.from_numpy(
                np.asarray(ins_logits, np.float32)).to(self.device)
            c, bag_logits, attn, _ = self.aggregator(f, None, ins_logits=c)
            scores = torch.sigmoid(bag_logits).reshape(-1).cpu().numpy()
            c, attn = c.cpu().numpy(), attn.cpu().numpy()
        if self.average:
            scores = testing_flow_average(scores, c)
        thres = self.thresholds if self.thresholds is not None \
            else np.full((scores.shape[0],), 0.5, np.float32)
        detected = [int(i) for i in np.nonzero(scores >= thres)[0]]
        return {
            "scores": scores.astype(np.float32),
            "detected": detected,
            "attention": attn,
            "ins_logits": c,
        }

    def predict_patches(self, images: np.ndarray,
                        timeout: Optional[float] = 120.0) -> Dict:
        """Bag prediction from raw patches: embed through the micro-batcher,
        then aggregate with the embedder head's instance logits."""
        feats, logits = self.embed_with_logits(images, timeout)
        return self.predict(feats, ins_logits=logits)

    # The render allocates a dense (max_col+1, max_row+1) grid upscaled x32
    # in float64 (~25 KB per grid CELL) from client-supplied coordinates, so
    # the grid AREA is bounded: 2^16 cells caps a render at ~1.6 GB.
    MAX_GRID_CELLS = 1 << 16

    def heatmap(self, images: np.ndarray, positions: np.ndarray,
                colors: Optional[np.ndarray] = None,
                timeout: Optional[float] = 120.0):
        """Predict from raw patches and render the attention color map on
        the tile grid. ``positions`` is [N, 2] (col, row) tile coordinates;
        ``colors`` an optional [num_classes, 3] RGB-in-[0,255] palette.

        Returns ``(image01 [W*32, H*32, 3] float, result dict)``."""
        images = np.ascontiguousarray(images)
        positions = np.asarray(positions)
        if images.shape[0] == 0:
            raise ValueError("empty bag (0 patches) cannot be rendered")
        if positions.ndim != 2 or positions.shape != (images.shape[0], 2):
            raise ValueError(f"positions must be [{images.shape[0]}, 2], "
                             f"got {positions.shape}")
        if positions.min() < 0:
            raise ValueError("positions must be non-negative tile-grid "
                             "indices")
        positions = positions.astype(np.int64)
        cells = int(positions[:, 0].max() + 1) * int(positions[:, 1].max() + 1)
        if cells > self.MAX_GRID_CELLS:
            raise ValueError(
                f"tile grid too large to render in-service: "
                f"{cells} cells > {self.MAX_GRID_CELLS}")
        if colors is None:
            colors = _DEFAULT_PALETTE
        result = self.predict_patches(images, timeout)
        from tpumil_torch.infer.heatmap import render_color_map

        image01 = render_color_map(result["attention"], positions,
                                   result["detected"],
                                   [np.asarray(colors[c % len(colors)])
                                    for c in range(self.num_classes)])
        return image01, result

    # -- ops ----------------------------------------------------------------

    def health(self) -> Dict:
        return {
            "status": "ok",
            "backend": self.device.type,
            "model": self.model if self.aggregator is not None else None,
            "backbone": self.embedder.cfg.backbone,
            "batch_size": self.batch_size,
            "patch_size": self.patch_size,
            "num_feats": self.num_feats,
            "num_classes": self.num_classes,
        }

    def stats(self) -> Dict:
        return self._batcher.stats.as_dict(self.batch_size)

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
