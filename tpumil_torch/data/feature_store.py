"""Precomputed bag-feature store (counterpart of
tpumil/data/feature_store.py), with the standard library's ``csv`` and
numpy in place of pandas.

Filesystem contracts (the reference's):
  * per-bag CSV: one row per instance, K feature columns under a header row
    of column numbers, floats written as ``%.4f``;
  * master dataset CSV ``datasets/<ds>/<ds>.csv``: column 0 = bag CSV path,
    column 1 = integer class, under the header ``0,label``; one such list per
    class beside it (``<class>.csv``);
  * bags are cached as ``.npz`` (feats float32 [N, K] + label [C]) with the
    reference's row shuffle applied once at cache time.
"""

from __future__ import annotations

import csv
import glob
import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpumil_torch.data.bags import Bag


def read_master_csv(path: str) -> List[Tuple[str, int]]:
    """Read the master bag list ``<ds>.csv`` -> [(bag_csv_path, label)]."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [(row[0], int(float(row[1]))) for row in rows[1:] if row]


def encode_label(raw_label: int, num_classes: int) -> np.ndarray:
    """Binary tasks store the raw value in slot 0; multi-class tasks one-hot
    iff the index is in range."""
    label = np.zeros(num_classes, dtype=np.float32)
    if num_classes == 1:
        label[0] = float(raw_label)
    elif int(raw_label) <= num_classes - 1:
        label[int(raw_label)] = 1.0
    return label


def read_bag_csv(path: str, shuffle_rows: bool = False,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Read one per-bag feature CSV (header row, K float columns)."""
    feats = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                       ndmin=2).astype(np.float32)
    if shuffle_rows:
        rng = rng or np.random.default_rng()
        feats = feats[rng.permutation(feats.shape[0])]
    return feats


def resolve_bag_path(entry_path: str, dataset: str) -> str:
    """``--dataset TCGA-lung-default`` remaps the listed path into the
    downloaded tcga_lung_data_feats folder."""
    if dataset == "TCGA-lung-default":
        name = entry_path.split("/")[1]
        return os.path.join("datasets", "tcga-dataset", "tcga_lung_data_feats",
                            name + ".csv")
    return entry_path


class BagCache:
    """Cache bag CSVs as npz files and serve them as Bags. The cache
    directory is wiped and rebuilt from the master CSV; each bag's rows are
    shuffled once at build time, from ``np.random.default_rng(seed)``."""

    def __init__(self, cache_dir: str = "temp_train"):
        self.cache_dir = cache_dir

    def build(self, entries: Sequence[Tuple[str, int]], num_classes: int,
              dataset: str = "", seed: int = 0,
              log=lambda s: None) -> List[str]:
        if os.path.exists(self.cache_dir):
            shutil.rmtree(self.cache_dir, ignore_errors=True)
        os.makedirs(self.cache_dir, exist_ok=True)
        rng = np.random.default_rng(seed)
        paths = []
        seen = {}
        for i, (entry_path, raw_label) in enumerate(entries):
            csv_path = resolve_bag_path(entry_path, dataset)
            feats = read_bag_csv(csv_path, shuffle_rows=True, rng=rng)
            label = encode_label(raw_label, num_classes)
            name = os.path.splitext(os.path.basename(csv_path))[0]
            # same-named bags in different class folders must not overwrite
            # each other: disambiguate by the folder
            if seen.get(name, csv_path) != csv_path:
                parent = os.path.basename(os.path.dirname(csv_path))
                name = f"{parent}_{name}" if parent else name
                while seen.get(name, csv_path) != csv_path:
                    name = f"{name}_{i}"
            seen.setdefault(name, csv_path)
            out = os.path.join(self.cache_dir, name + ".npz")
            np.savez_compressed(out, feats=feats, label=label)
            paths.append(out)
            log(f"\r Caching bag [{i + 1}/{len(entries)}]")
        log("\n")
        return paths

    @staticmethod
    def load(path: str) -> Bag:
        data = np.load(path)
        name = os.path.splitext(os.path.basename(path))[0]
        return Bag(feats=np.asarray(data["feats"], np.float32),
                   label=np.asarray(data["label"], np.float32), name=name)

    def load_all(self, paths: Optional[Sequence[str]] = None) -> List[Bag]:
        if paths is None:
            paths = sorted(glob.glob(os.path.join(self.cache_dir, "*.npz")))
        return [self.load(p) for p in paths]


def write_bag_csv(feats: np.ndarray, path: str) -> None:
    """Write a per-bag feature CSV in the reference's format: integer column
    header 0..K-1, ``%.4f`` floats."""
    feats = np.asarray(feats)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = ",".join(str(j) for j in range(feats.shape[1]))
    np.savetxt(path, feats, fmt="%.4f", delimiter=",", header=header,
               comments="")


def _write_bag_list(path: str, rows: Sequence[Tuple[str, int]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["0", "label"])
        writer.writerows(rows)


def build_dataset_csvs(feats_root: str, dataset: str,
                       out_dir: Optional[str] = None,
                       rng: Optional[np.random.Generator] = None) -> str:
    """Assemble the per-class bag lists and the shuffled master CSV from a
    directory of per-class bag CSVs. Classes are the sorted subdirectories
    of ``feats_root`` and their labels are their positions in that order;
    the master's rows are permuted by ``rng.permutation``. Returns the
    master CSV's path."""
    out_dir = out_dir or feats_root
    class_dirs = sorted(d for d in glob.glob(os.path.join(feats_root, "*"))
                        if os.path.isdir(d))
    rows: List[Tuple[str, int]] = []
    for label, class_dir in enumerate(class_dirs):
        bag_csvs = sorted(c for c in glob.glob(os.path.join(class_dir, "*.csv"))
                          if not c.endswith(".pos.csv"))  # position sidecars
        mine = [(path, label) for path in bag_csvs]
        _write_bag_list(os.path.join(out_dir, os.path.basename(class_dir)
                                     + ".csv"), mine)
        rows.extend(mine)
    rng = rng or np.random.default_rng()
    master = os.path.join(out_dir, dataset + ".csv")
    _write_bag_list(master, [rows[j] for j in rng.permutation(len(rows))])
    return master
