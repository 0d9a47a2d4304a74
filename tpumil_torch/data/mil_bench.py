"""Classic MIL benchmark datasets, Musk1/2, Elephant, Fox and Tiger (a
numpy copy of tpumil/data/mil_bench.py; ``tpumil/__init__.py`` imports
JAX).

Parses the svmlight-like format of the reference (train_mil.py:17-40):
each line is ``<inst_id>:<bag_id>:<class> <feat_idx>:<value> ...``, read as
a single-column CSV whose first line is consumed as a header, as
``pd.read_csv`` does in the reference. Bags are assembled by bag id; the
bag label is the class field of the bag's first instance, clipped to
{0, 1}.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tpumil_torch.data.bags import Bag

# draws of shuffle_with_class_coverage before it gives up
SHUFFLE_TRIES = 1000

DATASET_FILES = {
    # dataset name -> (relative path under datasets/mil_dataset, feature
    # count) (train_mil.py:127-141)
    "musk1": ("Musk/musk1norm.svm", 166),
    "musk2": ("Musk/musk2norm.svm", 166),
    "elephant": ("Elephant/data_100x100.svm", 230),
    "fox": ("Fox/data_100x100.svm", 230),
    "tiger": ("Tiger/data_100x100.svm", 230),
}


def parse_mil_file(path: str, num_feats: Optional[int] = None,
                   skip_header: bool = True) -> List[Bag]:
    """Parse an svmlight-like MIL file into a list of Bags (bag order = bag
    id order; instance order preserved)."""
    bags: dict[int, dict] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    if skip_header and lines:
        # the reference reads via pd.read_csv, which consumes line 0 as header
        lines = lines[1:]
    for line in lines:
        line = line.strip()
        if not line:
            continue
        fields = line.split(" ")
        ids = fields[0].split(":")
        bag_id, cls = int(ids[1]), int(ids[2])
        pairs = fields[1:]
        vec = np.zeros(len(pairs) if num_feats is None
                       else max(len(pairs), num_feats), dtype=np.float32)
        for i, pair in enumerate(pairs):
            kv = pair.split(":")
            if len(kv) == 2:
                vec[i] = float(kv[1])
        if num_feats is not None:
            vec = vec[:num_feats]
        entry = bags.setdefault(bag_id, {"label": cls, "rows": []})
        entry["rows"].append(vec)
    out = []
    for bag_id in sorted(bags):
        e = bags[bag_id]
        label = np.asarray([float(np.clip(e["label"], 0, 1))], dtype=np.float32)
        out.append(Bag(feats=np.stack(e["rows"]), label=label, name=str(bag_id)))
    return out


def cross_validation_split(items: list, fold: int, index: int
                           ) -> Tuple[list, list]:
    """Contiguous-chunk k-fold split (train_mil.py:99-104): chunk size
    ``len // fold``; chunk ``index`` is the test set, the rest train. A
    remainder chunk (when len % fold != 0) stays in training, as the
    reference's chunking keeps it."""
    n = len(items) // fold
    if n == 0:
        raise ValueError(
            f"cv_fold={fold} exceeds the number of bags ({len(items)}); "
            f"use at most {len(items)} folds")
    chunks = [items[i:i + n] for i in range(0, len(items), n)]
    test = chunks.pop(index)
    train = [x for ch in chunks for x in ch]
    return train, test


def compute_pos_weight(bags: List[Bag]) -> float:
    """(negatives / positives) for BCE pos_weight (train_mil.py:106-110)."""
    pos = sum(float(np.clip(b.label[0], 0, 1)) for b in bags)
    return (len(bags) - pos) / pos


def shuffle_with_class_coverage(bags: List[Bag], cv_fold: int,
                                rng: np.random.Generator) -> List[Bag]:
    """Shuffle bags until every CV test split holds at least one positive
    bag (train_mil.py:152-162)."""
    for _ in range(SHUFFLE_TRIES):
        order = rng.permutation(len(bags))
        shuffled = [bags[i] for i in order]
        ok = True
        for k in range(cv_fold):
            _, test = cross_validation_split(shuffled, cv_fold, k)
            if sum(float(np.clip(b.label[0], 0, 1)) for b in test) <= 0:
                ok = False
                break
        if ok:
            return shuffled
    raise RuntimeError("could not find a class-covering shuffle")
