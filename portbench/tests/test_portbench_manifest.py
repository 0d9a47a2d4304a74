"""The manifest and the files it names follow the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO, with_held

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
PL_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
BUDGET_S, SPARE_S, COMPILE_S = 43200, 1200, 2 * 90


@pytest.fixture(scope="module", params=["committed", "held cells added"])
def manifest(request):
    """The committed manifest, and the one the held cells' entries would
    make (PERF.md, Open questions)."""
    committed = json.loads((REPO / "BENCHMARK.json").read_text())
    return committed if request.param == "committed" else \
        with_held(committed)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")


def test_names_and_units(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(manifest):
    assert 1 <= len(manifest["configs"]) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        body = json.loads((REPO / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body, key
            assert key in body["reduced"], key
            assert not key.endswith(("_dim", "_rank", "_size")), key


def test_workloads(manifest):
    w = manifest["workloads"]
    assert 1 <= len(w) <= 24
    pairs = [(x["config"], x["traffic"]) for x in w]
    assert len(pairs) == len(set(pairs))
    four = sum(x["chips"] == 4 for x in w)
    assert four <= max(1, len(w) // 4)
    configs = {c["name"] for c in manifest["configs"]}
    for x in w:
        assert set(x) == {"name", "config", "traffic", "chips", "why"}
        assert x["chips"] in (1, 4) and x["config"] in configs
        assert NAME.match(x["traffic"]) and _line(x["why"])
        spec = json.loads((REPO / "portbench" / "workloads"
                           / f"{x['name']}.json").read_text())
        assert spec["config"] == x["config"] and spec["chips"] == x["chips"]
        assert spec["traffic"]["name"] == x["traffic"]
        assert (REPO / "portbench" / "drivers"
                / f"{spec['driver']}.py").is_file()


def test_metrics_cover_every_cell(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(manifest["per_layer"]) <= 128
    for m in manifest["end_to_end"]:
        assert set(m) <= E2E_KEYS and m["source"] in ("host_clock",
                                                      "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells

    def reports(cell, kind):
        return [m for m in manifest[kind]
                if cell in m.get("workloads", cells)]

    for cell in cells:
        assert len(reports(cell, "end_to_end")) >= 2, cell
        assert reports(cell, "per_layer"), cell
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= PL_KEYS and _line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        family = m["name"].split(".")[0]
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file() \
            or (REPO / "portbench" / "metrics" / f"{family}.py").is_file()
        if family in ("device_idle_pct",):
            layers.setdefault(family, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in manifest["per_layer"]:
        if "mfu" in m["name"] or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check(manifest):
    r = manifest["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (r + 60) + cells * COMPILE_S + SPARE_S <= BUDGET_S
