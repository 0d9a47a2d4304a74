"""The inference slice's CLIs against the JAX package's: attention_map,
testing_tcga and testing_c16 (tpumil_torch/cli/ against tpumil/cli/), both
with --device cpu, on the same folder of 224^2 JPEG bags, the same seeded
embedder .pth and the shipped aggregators with their shipped thresholds.

The CLIs print verdicts and write PNGs (and attention CSVs); the bag scores
are read by wrapping each package's BagInference.run_bag. Verdict lines are
compared for every bag whose score lies farther than TOL from its
threshold; a bag inside it is reported and left out of that comparison.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpumil.cli import attention_map as jax_am
from tpumil.cli import testing_c16 as jax_c16
from tpumil.cli import testing_tcga as jax_tcga
from tpumil.infer import heatmap as jheat
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil_torch.cli import attention_map, testing_c16, testing_tcga
from tpumil_torch.infer import heatmap

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = dict(rtol=1e-4, atol=1e-4)
BAGS = (5, 7, 6)  # patches per bag: at batch 4 every bag's last batch is ragged
CLIS = {"attention_map": (attention_map, jax_am),
        "testing_tcga": (testing_tcga, jax_tcga),
        "testing_c16": (testing_c16, jax_c16)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Bags of 224^2 JPEG patches at grid positions with holes, and a
    seeded embedder exported as a .pth."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for b, n in enumerate(BAGS):
        d = root / "patches" / f"slide{b}"
        d.mkdir(parents=True)
        for k in range(n):
            Image.fromarray(rng.integers(0, 256, (224, 224, 3), np.uint8)) \
                .save(d / f"{k // 3}_{2 * (k % 3) + b % 2}.jpg")
    cfg = jemb.EmbedderConfig(num_classes=1, compute_dtype=jnp.float32)
    params = jemb.init_params(jax.random.PRNGKey(0), cfg)
    emb = str(root / "embedder.pth")
    jckpt.save_state_dict(jemb.export_embedder_state_dict(params, cfg), emb)
    return root, emb


def _record(monkeypatch, cls):
    """Wrap ``cls.run_bag``; returns the list it appends (bag, outputs) to."""
    calls = []
    real = cls.run_bag

    def run_bag(self, bag_dir, *args, **kwargs):
        out = real(self, bag_dir, *args, **kwargs)
        calls.append((bag_dir, out))
        return out
    monkeypatch.setattr(cls, "run_bag", run_bag)
    return calls


def _decode(path):
    return np.asarray(Image.open(path), np.int32)


def _run_both(name, argv_for, monkeypatch, capsys, tmp_path):
    """Run the JAX CLI and the port's, each with ``argv_for(its output
    folder)``; returns {side: (stdout lines, run_bag calls, output
    folder)}."""
    port_mod, jax_mod = CLIS[name]
    runs = {}
    for side, mod, cls in (("jax", jax_mod, jheat.BagInference),
                           ("port", port_mod, heatmap.BagInference)):
        calls = _record(monkeypatch, cls)
        out = tmp_path / side
        assert mod.main(argv_for(out) + ["--device", "cpu"]) == 0
        runs[side] = (capsys.readouterr().out.splitlines(), calls, out)
    return runs


def _compare(runs, thresholds):
    """Scores, attention and PNGs of every bag; the verdict lines of the
    bags clear of their thresholds. Returns how many bags were compared."""
    (jax_lines, jax_calls, jax_out), (port_lines, port_calls, port_out) = \
        runs["jax"], runs["port"]
    assert [b for b, _ in port_calls] == [b for b, _ in jax_calls]
    assert len(port_calls) == len(BAGS) == len(port_lines) == len(jax_lines)
    clear = 0
    for (bag, got), (_, want), pl, jl in zip(port_calls, jax_calls,
                                             port_lines, jax_lines):
        scores = np.atleast_1d(np.squeeze(got[0]))
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[1], want[1], **TOL)
        np.testing.assert_allclose(got[2], want[2], **TOL)
        np.testing.assert_array_equal(got[3], want[3])
        near = [abs(s - t) <= TOL["atol"] + TOL["rtol"] * abs(t)
                for s, t in zip(scores, thresholds)]
        if any(near):
            print(f"{bag}: a score within TOL of its threshold "
                  f"({scores} against {thresholds}); verdict not compared")
        else:
            assert pl == jl
            clear += 1
        name = os.path.basename(bag) + ".png"
        png, ref = _decode(port_out / "maps" / name), \
            _decode(jax_out / "maps" / name)
        assert png.shape == ref.shape and np.abs(png - ref).max() <= 1
    return clear


def test_attention_map_cli_matches_jax(inputs, tmp_path, monkeypatch, capsys):
    root, emb = inputs
    thres = [0.7371, 0.2752]  # the CLI's defaults
    argv = ["--embedder_weights", emb, "--aggregator_weights",
            os.path.join(DATA, "tcga_aggregator.pth"),
            "--bag_path", str(root / "patches"), "--batch_size", "4",
            "--num_workers", "2", "--export_scores", "1", "--seed", "0"]
    runs = _run_both("attention_map", lambda out: argv + [
        "--map_path", str(out / "maps"), "--score_path", str(out / "scores")],
        monkeypatch, capsys, tmp_path)
    assert _compare(runs, thres) >= 1
    for bag in range(len(BAGS)):
        a, b = (np.loadtxt(tmp_path / side / "scores" / f"slide{bag}.csv",
                           delimiter=",", skiprows=1, usecols=(0, 1))
                for side in ("port", "jax"))
        assert a.shape == (BAGS[bag], 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,aggregator,thresholds", [
    ("testing_tcga", "tcga", [0.45798203349113464, 0.5827295184135437]),
    ("testing_c16", "c16", [0.5282700061798096])])
def test_testing_cli_matches_jax(inputs, tmp_path, monkeypatch, capsys, name,
                                 aggregator, thresholds):
    root, emb = inputs
    argv = ["--embedder_weights", emb, "--aggregator_weights",
            os.path.join(DATA, f"{aggregator}_aggregator.pth"),
            "--bag_path", str(root / "patches"), "--batch_size", "4",
            "--num_workers", "2"]
    runs = _run_both(name, lambda out: argv + ["--output", str(out / "maps")],
                     monkeypatch, capsys, tmp_path)
    assert _compare(runs, thresholds) >= 1
    verdicts = {"testing_tcga": (": LUAD", ": LUSC", ": benign",
                                 ": both LUAD and LUSC"),
                "testing_c16": (" as malignant", " as benign")}[name]
    assert all(line.endswith(verdicts) for line in runs["port"][0])


def _flags(parse):
    """{dest: default} of the parser that ``parse`` builds."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            parse()
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_flags_match_jax(name):
    """The JAX CLI's flag surface and defaults, with cuda in place of auto."""
    port_mod, jax_mod = CLIS[name]
    port = _flags(lambda: port_mod.parse_args([]))
    jax_flags = _flags(lambda: jax_mod.main([]))
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags
    assert sys.modules[f"tpumil_torch.cli.{name}"] is port_mod


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_refusals(name, tmp_path, monkeypatch):
    """--data_parallel's refusals (JAX's messages); no --device is the
    card, which raises without one before any file is read."""
    port_mod, _ = CLIS[name]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="must be >= 0, got -1"):
        port_mod.main(["--device", "cpu", "--data_parallel", "-1"])
    with pytest.raises(ValueError, match="batch_size 64 must divide by"):
        port_mod.main(["--device", "cpu", "--data_parallel", "3"])
    assert not os.listdir(tmp_path)
    assert port_mod.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_mod.main([])
