"""Whole runs of the cells on the CPU at small sizes (the harness's look
for a card skipped): sound runs come out correct, runs with a fault
planted underneath the timed path come out not correct; a run without a
card fails; a cell, a configuration and a metric are added as files
alone."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, copy_checkout, shrink
from portbench import faults, harness, run

CPU = torch.device("cpu")
FAULTS_OF = {"tcga-train": ("state_unchanged", "half_batch"),
             "simclr-b4096": ("state_unchanged", "half_batch"),
             "tcga-extract": ("answer_altered",),
             "tcga-serve": ("answer_altered",)}
SECONDS = 0.2


def _run(root, cell, trace=False, seed=2 ** 31 + 3):
    return run.run_cell(root, cell, seed, SECONDS, trace, CPU,
                        time.perf_counter())


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.mark.parametrize("cell", sorted(FAULTS_OF))
def test_sound_run_is_correct(small_checkout, cell):
    res = _run(small_checkout, cell)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    manifest = harness.load_manifest(small_checkout)
    e2e = harness.cell_metrics(manifest, cell, "end_to_end")
    # a metric from the device's trace has nothing to read on the CPU
    want = {m["name"] for m in e2e if m["source"] != "device_trace"}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS_OF)
                                        for f in FAULTS_OF[c]])
def test_planted_fault_is_not_correct(small_checkout, cell, fault):
    undo = faults.PLANT[fault]()
    try:
        res = _run(small_checkout, cell)
    finally:
        undo()
    assert not res["correct"], res["compared"]


def test_traced_run_reports_per_layer_metrics(small_checkout):
    res = _run(small_checkout, "tcga-train", trace=True)
    assert res["correct"]
    assert {"mfu_pct.train", "step_wall_ms.train"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_without_a_card_there_is_no_result(tmp_path):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "tcga-train",
           "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, env=_no_card_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    # nor in a directory that holds the benchmark's files alone
    bare = copy_checkout(tmp_path / "bare")
    out = subprocess.run(cmd, cwd=bare, env=_no_card_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_the_guard_sees_jax_by_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpumil_torch_fake.x", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax"]


DUMMY_DRIVER = '''
from portbench import harness

def setup(cell):
    return {"n": int(cell.traffic["items"]), "cell": cell}

def window(state, seconds):
    t0 = harness.now()
    total = sum(range(state["n"]))
    return harness.Window(harness.now() - t0 + 1e-6, state["n"], 0,
                          {"dummy_items_per_s": state["n"] / 1e-3},
                          {"total": total})

def observe(state):
    return {"total": sum(range(state["n"]))}

def reference(state, observed, precision):
    return {"total": state["n"] * (state["n"] - 1) // 2}

def compare(state, observed, readings):
    return [harness.Compared("total_gap", abs(observed["total"]
                                              - readings["total"]), 0.0)]

def as_observed(state, observed, readings):
    return readings

def close(state):
    pass
'''

DUMMY_METRIC = '''
def read(ctx, name):
    return float(ctx.window.counters["total"])
'''


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = copy_checkout(tmp_path / "checkout")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    (pb / "configs" / "dummy-config.json").write_text(json.dumps(
        {"name": "dummy-config", "items": 100, "reduced": {}}))
    (pb / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"config": "dummy-config", "driver": "dummy_driver", "chips": 1,
         "why": "a test", "traffic": {"name": "dummy-mix", "items": 100},
         "limits": {}}))
    (pb / "drivers" / "dummy_driver.py").write_text(DUMMY_DRIVER)
    (pb / "metrics" / "dummy_total.py").write_text(DUMMY_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dummy-config", "source": "a test",
                                "file": "portbench/configs/dummy-config.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "dummy-cell",
                                  "config": "dummy-config",
                                  "traffic": "dummy-mix", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({"name": "dummy_items_per_s",
                                   "unit": "items/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["dummy-cell"]})
    manifest["per_layer"].append({"name": "dummy_total.x", "unit": "items",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "a test",
                                  "moves": "dummy_items_per_s",
                                  "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    # no file the benchmark had was edited
    assert all(p.read_bytes() == b for p, b in before.items())
    res = _run(root, "dummy-cell")
    assert res["correct"]
    assert set(res["metrics"]) == {"dummy_items_per_s", "setup_s"}
    res = _run(root, "dummy-cell", trace=True)
    assert res["metrics"] == {"dummy_total.x": {"value": 4950.0,
                                                "unit": "items"}}
