"""Driver ``compute_feats``: feature extraction of patch folders to per-bag
CSVs, as ``cli/compute_feats.py`` runs it.

Set-up makes the cell's bags of tissue-like patches on the device from the
seed (``traffic/images.py``), writes them as JPEGs at the tiler's quality
into a scratch tree ``single/<class>/<bag>/<col>_<row>.jpeg`` under
``TMPDIR``, makes the ResNet18-IN weights on the device, loads them into
the program's ``Embedder`` and builds a ``FeatureExtractor`` (batch, decode
workers and precision from the configuration). Warm-up embeds one batch and
runs one small bag through ``compute_feats``. The window runs
``infer.features.compute_feats([bag], extractor, out)`` a bag at a time,
cycling over the bags, until ``--seconds`` have passed;
``extract_patches_per_s`` is the patches of every pass over the time to the
end of the last.

The check, once the window has closed: rows drawn from the seed out of the
window's CSVs against the plain reference's features
(``reference/resnet.py``) of the same JPEGs, decoded by PIL; and every
CSV holds every patch's row.

Its cell, ``tcga-extract``, is held out of ``BENCHMARK.json`` until its
rate can be bounded (PERF.md, Open questions); the driver serves it as it
stands, and the CPU tests run it through the held entries.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.reference import resnet as ref
from portbench.traffic import images as traffic_images

CLASSES = ("LUAD", "LUSC")


@dataclasses.dataclass
class State:
    cell: harness.Cell
    extractor: Any
    weights: Dict[str, torch.Tensor]
    bags: List[str]                 # bag directories
    paths: List[List[str]]          # each bag's patches, in row order
    out: Path
    passes: List[tuple] = dataclasses.field(default_factory=list)


def _bag_tree(root: Path, n_bags: int, per_bag: int, grid: int
              ) -> List[List[str]]:
    bags = []
    for b in range(n_bags):
        d = root / "single" / CLASSES[b % len(CLASSES)] / f"slide{b:03d}"
        bags.append(sorted(str(d / f"{i % grid}_{i // grid}.jpeg")
                           for i in range(per_bag)))
    return bags


def _write_bags(cell, paths: List[List[str]], salt: int) -> None:
    tp = cell.traffic
    gen = cell.generator(salt)
    for bag in paths:
        imgs = traffic_images.tissue(len(bag), int(tp["size"]), gen,
                                     cell.device).cpu().numpy()
        traffic_images.write_jpegs(imgs, bag, int(tp["jpeg_quality"]),
                                   int(tp.get("writers", 8)))


def setup(cell: harness.Cell) -> State:
    from tpumil_torch.infer.features import FeatureExtractor, compute_feats
    from tpumil_torch.models.embedder import Embedder, EmbedderConfig

    emb, tp = cell.config["embedder"], cell.traffic
    n_bags, per_bag = int(tp["bags"]), int(tp["patches_per_bag"])
    grid = int(np.ceil(np.sqrt(per_bag)))
    paths = _bag_tree(cell.scratch / "patches", n_bags, per_bag, grid)
    _write_bags(cell, paths, 1)
    warm = _bag_tree(cell.scratch / "warm", 1, 2 * int(emb["batch_size"]),
                     grid)
    _write_bags(cell, warm, 2)

    weights = ref.make_weights(cell.generator(3), cell.device)
    model = Embedder(EmbedderConfig(
        backbone=emb["backbone"], norm=emb["norm"],
        num_classes=int(cell.config["aggregator"]["num_classes"]),
        precision=emb["precision"]), cell.device)
    model.feature_extractor.load_state_dict(weights)
    extractor = FeatureExtractor(model, batch_size=int(emb["batch_size"]),
                                 patch_size=int(emb["patch_size"]),
                                 num_workers=int(emb["num_workers"]))
    # warm-up: the batch shape, the kernels' first build, the loader
    extractor.embed_arrays(np.zeros((int(emb["batch_size"]),
                                     int(emb["patch_size"]),
                                     int(emb["patch_size"]), 3), np.uint8))
    compute_feats([os.path.dirname(warm[0][0])], extractor,
                  str(cell.scratch / "warm-out"))
    return State(cell, extractor, weights,
                 [os.path.dirname(b[0]) for b in paths], paths,
                 cell.scratch / "out")


def _csv_rows(path: str) -> int:
    if not os.path.isfile(path):
        return 0
    with open(path, "rb") as f:
        return max(sum(1 for _ in f) - 1, 0)  # less the header


def window(state: State, seconds: float) -> harness.Window:
    from tpumil_torch.infer.features import compute_feats

    emb = state.cell.config["embedder"]
    patches, missing, i = 0, 0, 0
    t0 = harness.now()
    while True:
        b = i % len(state.bags)
        out = state.out / f"pass{i:04d}"
        compute_feats([state.bags[b]], state.extractor, str(out))
        cls, bag = state.bags[b].split(os.sep)[-2:]
        csv = str(out / cls / f"{bag}.csv")
        state.passes.append((i, b, csv))
        patches += len(state.paths[b])
        missing += len(state.paths[b]) - min(_csv_rows(csv),
                                             len(state.paths[b]))
        i += 1
        elapsed = harness.now() - t0
        if elapsed >= seconds:
            break
    batch = int(emb["batch_size"])
    batches = sum(-(-len(state.paths[b]) // batch) for _, b, _ in state.passes)
    return harness.Window(
        seconds=elapsed, attempted=patches, failed=missing,
        end_to_end={"extract_patches_per_s": patches / elapsed},
        counters={"patches": patches, "batches": batches,
                  "batch_size": batch,
                  "resnet_forward": {"images": batches * batch,
                                     "size": int(emb["patch_size"]),
                                     "dtype": _dtype_name(emb["precision"])}})


def _dtype_name(precision: str) -> str:
    return "bfloat16" if precision == "bf16" else "float32"


def observe(state: State) -> Dict[str, Any]:
    """Rows drawn from the seed out of the window's CSVs (their pass, bag,
    row and values), and the rows missing; frees the extractor."""
    state.extractor = None
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    n = int(state.cell.spec["check_rows"])
    rng = state.cell.rng(4)
    picks = [(p, int(r)) for p in range(len(state.passes))
             for r in rng.choice(len(state.paths[state.passes[p][1]]),
                                 -(-n // len(state.passes)), replace=False)]
    rows, missing, lines = [], 0, {}
    for p, r in picks:
        _, b, csv = state.passes[p]
        if p not in lines:
            with open(csv) if os.path.isfile(csv) else open(os.devnull) as f:
                lines[p] = f.readlines()[1:]  # less the header
            missing += len(state.paths[b]) - min(len(lines[p]),
                                                 len(state.paths[b]))
        got = (np.array(lines[p][r].split(","), np.float64)
               if r < len(lines[p]) else None)
        rows.append((b, r, got))
    return {"rows": rows, "missing": missing}


def reference(state: State, observed, precision: str) -> Dict[str, Any]:
    """The reference's features of the sampled rows' patches, in f32
    ("stated") or with TF32 allowed ("lower", the control)."""
    tf32 = precision == "lower"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        files = [state.paths[b][r] for b, r, _ in observed["rows"]]
        imgs = torch.from_numpy(ref.decode_jpegs(files)).to(state.cell.device)
        feats = ref.features(state.weights, imgs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {"feats": feats.double().cpu().numpy()}


def compare(state: State, observed, readings) -> List[harness.Compared]:
    limits = state.cell.spec["limits"]
    gap = 0.0
    absent = 0
    for (_, _, got), want in zip(observed["rows"], readings["feats"]):
        if got is None or got.shape != want.shape:
            absent += 1
            continue
        gap = max(gap, float(np.max(np.abs(got - want))))
    return [harness.Compared("feat_gap", gap, limits["feat_gap"]),
            harness.Compared("rows_missing", float(observed["missing"]
                                                   + absent), 0.0)]


def as_observed(state: State, observed, readings) -> Dict[str, Any]:
    """Reference features in the program's place: the sampled rows as the
    CSV would hold them (``%.4f``), none missing."""
    rows = [(b, r, np.round(f, 4)) for (b, r, _), f in
            zip(observed["rows"], readings["feats"])]
    return {"rows": rows, "missing": 0}


def close(state: State) -> None:
    state.weights = {}
