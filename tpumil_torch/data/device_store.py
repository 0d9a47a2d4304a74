"""Device-resident bag store (counterpart of tpumil/data/device_store.py).

The bags stay unpadded: one flat ``[sum N, K]`` feature tensor on the
device plus row offsets, so an epoch moves no feature bytes from the host
and a bag is a contiguous slice. The JAX store's grouping by bucket length
is kept as bookkeeping only (``bucket_sizes``, ``index``, ``counts``): the
trainer visits bucket by bucket and draws its permutations per bucket, so
visitation order and host RNG draws are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpumil_torch.data.bags import Bag, bucket_length
from tpumil_torch.utils.device import select_device


class DeviceBagStore:
    """Bags resident on ``device`` (None: the card; raises without one),
    their features held in ``dtype`` (f32, or bf16 for half the bytes: the
    trainers' forwards cast each bag to their compute dtype). ``bag(i)`` is
    bag ``i``'s ``[N_i, K]`` slice; ``index[nmax]`` lists, in bucket-row
    order, the positions of the bags whose bucket length is ``nmax``;
    ``counts[nmax]`` is their number."""

    def __init__(self, bags: Sequence[Bag], min_bucket: int = 16,
                 device: Optional[torch.device] = None,
                 dtype: torch.dtype = torch.float32):
        device = select_device("cuda") if device is None else device
        sizes = [b.num_instances for b in bags]
        feats = np.concatenate([np.asarray(b.feats, np.float32) for b in bags])
        labels = np.stack([np.atleast_1d(b.label) for b in bags])
        groups: Dict[int, List[int]] = {}
        for i, n in enumerate(sizes):
            groups.setdefault(bucket_length(n, min_bucket), []).append(i)
        self._init(torch.from_numpy(feats).to(device, dtype),
                   np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                   labels.astype(np.float32), [b.name for b in bags],
                   {nmax: np.asarray(idx) for nmax, idx in sorted(groups.items())})

    def _init(self, feats, offsets, labels, names, index) -> None:
        self.feats = feats
        self.offsets = offsets
        self.labels = labels
        self.names = names
        self.index = index
        self.counts = {nmax: len(idx) for nmax, idx in index.items()}
        self.num_bags = len(names)
        self.num_classes = int(labels.shape[1])
        self._labels_dev = torch.from_numpy(labels).to(feats.device)

    @property
    def device(self) -> torch.device:
        return self.feats.device

    @property
    def bucket_sizes(self) -> List[int]:
        return sorted(self.index)

    def bag(self, i: int) -> torch.Tensor:
        return self.feats[int(self.offsets[i]):int(self.offsets[i + 1])]

    def label(self, i: int) -> torch.Tensor:
        return self._labels_dev[i]

    def subset(self, indices: Sequence[int]) -> "DeviceBagStore":
        """A store over ``indices`` (positions in this store), in that
        order, gathered on the device. Inside a bucket the bags keep this
        store's bucket-row order, as the JAX store's subset does."""
        indices = [int(i) for i in indices]
        pos = {g: i for i, g in enumerate(indices)}
        rows = [np.arange(self.offsets[g], self.offsets[g + 1])
                for g in indices]
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        new = object.__new__(DeviceBagStore)
        sizes = [int(self.offsets[g + 1] - self.offsets[g]) for g in indices]
        index = {}
        for nmax, gidx in self.index.items():
            sel = [pos[int(g)] for g in gidx if int(g) in pos]
            if sel:
                index[nmax] = np.asarray(sel)
        new._init(self.feats.index_select(
                      0, torch.from_numpy(rows).to(self.device)),
                  np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                  self.labels[np.asarray(indices, np.int64)],
                  [self.names[g] for g in indices], index)
        return new

    def nbytes(self) -> int:
        return int(self.feats.nbytes + self.labels.nbytes)
