"""On the card: each cell's control, the plain reference computed in the
precision below the configuration's and put in the program's place, comes
out not correct, while the program comes out correct, at sizes a test run
holds (the cells' own sizes are read by ``python3 -m portbench.calibrate``,
PERF.md). Run on the card with ``python -m pytest portbench/tests``."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import copy_checkout, _merge
from portbench import calibrate, harness

# (traffic, configuration, cell keys) at a size a test run holds on the card
CARD = {
    "tcga-train": ({"bags": 16}, {}, {}),
    "tcga-extract": ({"bags": 1, "patches_per_bag": 256}, {},
                     {"check_rows": 64}),
    "simclr-b4096": ({"pool": 1024, "batch": 512}, {}, {}),
    "tcga-serve": ({"pool": 512}, {}, {"check_requests": 8}),
}


@pytest.fixture(scope="module")
def card_checkout(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = copy_checkout(tmp_path_factory.mktemp("card"))
    for cell, (traffic, config, keys) in CARD.items():
        spec_path = root / "portbench" / "workloads" / f"{cell}.json"
        spec = json.loads(spec_path.read_text())
        _merge(spec["traffic"], traffic)
        _merge(spec, keys)
        spec_path.write_text(json.dumps(spec))
        cfg_path = root / harness.config_entry(
            harness.load_manifest(root), spec["config"])["file"]
        cfg = json.loads(cfg_path.read_text())
        _merge(cfg, config)
        cfg_path.write_text(json.dumps(cfg))
    harness.set_cache_dirs(root)
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CARD))
def test_control_fails_and_program_passes(card_checkout, cell):
    r = calibrate.readings(card_checkout, cell, 2 ** 31 + 17, 1.0,
                           torch.device("cuda", 0), control=True)
    spec = json.loads((card_checkout / "portbench" / "workloads"
                       / f"{cell}.json").read_text())
    limits = dict(spec["limits"])
    limits.update({k: 0.0 for k in r["program"] if k not in limits})
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
