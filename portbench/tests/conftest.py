"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
(``BENCHMARK.json`` and ``portbench/``) in a temporary checkout, with a
cell's traffic and configuration cut to a size the CPU runs in seconds.
The ``cuda`` marker names the tests that need the card; they decide inside
the test whether there is one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# each cell at a size the CPU runs in seconds: (traffic, config, cell keys)
SMALL = {
    "tcga-train": ({"bags": 8, "median": 64, "min": 16, "max": 256},
                   {}, {}),
    "tcga-extract": ({"bags": 2, "patches_per_bag": 12},
                     {"embedder": {"batch_size": 4, "num_workers": 2}},
                     {"check_rows": 6}),
    # at a batch of 4 the f32 loss sits a few ulps from the reference's
    # (the cell's own limit is read at 4096 on the card)
    "simclr-b4096": ({"pool": 8, "batch": 4}, {"grad_cache_microbatch": 2},
                     {"limits": {"loss_gap": 1e-5}}),
    "tcga-serve": ({"pool": 32, "min_patches": 2, "max_patches": 8,
                    "rate_per_s": 8},
                   {}, {"server": {"batch_size": 8, "client_threads": 4,
                                   "max_wait_ms": 8.0},
                        "check_requests": 3}),
}

# Cells held out of BENCHMARK.json until their end-to-end metric can be
# bounded (PERF.md, Open questions): their manifest entries, which the
# copies below add back, so that their drivers and readers stay tested.
HELD = {
    "workloads": [
        {
            "name": "tcga-extract",
            "config": "dsmil-tcga-r18",
            "traffic": "jpeg-bags-4x4096",
            "chips": 1,
            "why": "4 bags x 4096 tissue-like 224^2 JPEGs through compute_feats: host PIL decode on 8 threads, K5 and 19 K4 sites a B=128 f32 forward, a CSV a bag"
        },
        {
            "name": "tcga-serve",
            "config": "dsmil-tcga-r18",
            "traffic": "embed-poisson",
            "chips": 1,
            "why": "open-loop Poisson /v1/embed requests of 16-256 patches (log-uniform) at 0.8 of the highest sustained rate: HTTP front, micro-batcher, K5/K4 at B=128 f32"
        }
    ],
    "end_to_end": [
        {
            "name": "extract_patches_per_s",
            "unit": "patches/s",
            "better": "higher",
            "bound": 0.25,
            "source": "host_clock",
            "workloads": [
                "tcga-extract"
            ]
        },
        {
            "name": "serve_p95_ms",
            "unit": "ms",
            "better": "lower",
            "bound": 0.25,
            "source": "host_clock",
            "workloads": [
                "tcga-serve"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "device_idle_pct.extract",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "extract_patches_per_s",
            "workloads": [
                "tcga-extract"
            ]
        },
        {
            "name": "mfu_pct.extract",
            "unit": "%",
            "better": "higher",
            "source": "host_clock",
            "layer": "model step",
            "moves": "extract_patches_per_s",
            "workloads": [
                "tcga-extract"
            ]
        },
        {
            "name": "stem_roofline_pct.extract",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels: ops/stem.py, csrc/stem.cu (K5)",
            "moves": "extract_patches_per_s",
            "workloads": [
                "tcga-extract"
            ]
        },
        {
            "name": "in_roofline_pct.extract",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels: ops/instance_norm.py, csrc/instance_norm.cu (K4)",
            "moves": "extract_patches_per_s",
            "workloads": [
                "tcga-extract"
            ]
        },
        {
            "name": "device_idle_pct.serve",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "serve_p95_ms",
            "workloads": [
                "tcga-serve"
            ]
        },
        {
            "name": "batch_fill_pct.serve",
            "unit": "%",
            "better": "higher",
            "source": "program_counter",
            "layer": "infer/service.py micro-batcher",
            "moves": "serve_p95_ms",
            "workloads": [
                "tcga-serve"
            ]
        }
    ]
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (run on the card with "
        "python -m pytest portbench/tests)")


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def with_held(manifest: dict) -> dict:
    """``manifest`` with the held cells' entries that it lacks added."""
    out = {k: list(v) if isinstance(v, list) else v
           for k, v in manifest.items()}
    for group, entries in HELD.items():
        names = {e["name"] for e in out[group]}
        out[group] += [e for e in entries if e["name"] not in names]
    return out


def copy_checkout(dst: Path) -> Path:
    """A copy of the benchmark's files at ``dst``, its manifest with the
    held cells' entries added."""
    dst.mkdir(parents=True, exist_ok=True)
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(with_held(manifest),
                                                   indent=2))
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def shrink(root: Path, cell: str) -> None:
    """Cut ``cell``'s traffic and configuration in the checkout at
    ``root`` to its CPU size."""
    traffic, config, spec_keys = SMALL[cell]
    spec_path = root / "portbench" / "workloads" / f"{cell}.json"
    spec = json.loads(spec_path.read_text())
    _merge(spec["traffic"], traffic)
    _merge(spec, spec_keys)
    spec_path.write_text(json.dumps(spec))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    cfg_file = next(c["file"] for c in manifest["configs"]
                    if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_file).read_text())
    _merge(cfg, config)
    (root / cfg_file).write_text(json.dumps(cfg))


@pytest.fixture
def small_checkout(tmp_path):
    """A copy of the benchmark with every cell cut to its CPU size."""
    root = copy_checkout(tmp_path / "checkout")
    for cell in SMALL:
        shrink(root, cell)
    return root
