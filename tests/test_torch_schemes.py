"""The port's metrics, feature store, checkpoints, WSI schemes and
train_wsi CLI against the JAX package's (tpumil/train/{metrics,schemes}.py,
tpumil/data/feature_store.py), on the same data and seeds."""

import glob
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_curve as sk_roc_curve
from sklearn.model_selection import KFold

from tpumil.data import feature_store as jfs
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import dsmil as jdsmil
from tpumil.train import metrics as jmetrics
from tpumil.train import schemes as jschemes
from tpumil_torch.cli import train_wsi
from tpumil_torch.data import feature_store
from tpumil_torch.data.bags import Bag
from tpumil_torch.io import from_jax, native_ckpt, torch_ckpt
from tpumil_torch.models.dsmil import DSMIL
from tpumil_torch.train import metrics, schemes
from tpumil_torch.train.trainer import BagTrainer

import torch_parallel_util as util
from synth import make_separable_bags

CPU = torch.device("cpu")


def _score_sets():
    rng = np.random.default_rng(0)
    out = []
    for n in (7, 20, 51):
        labels = (rng.random(n) > 0.5).astype(np.float32)
        out.append((labels, rng.random(n).astype(np.float32)))
        # ties: scores on a coarse grid, within and across classes
        out.append((labels, np.round(rng.random(n) * 4) / 4))
    out.append((np.ones(6, np.float32), rng.random(6)))   # one class only
    out.append((np.zeros(6, np.float32), rng.random(6)))
    return out


@pytest.mark.parametrize("case", range(8))
def test_roc_and_auc_match_sklearn(case):
    labels, scores = _score_sets()[case]
    with np.errstate(invalid="ignore"):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = sk_roc_curve(labels, scores, pos_label=1)
    got = metrics.roc_curve(labels, scores, pos_label=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    aucs, _, th = metrics.multi_label_roc(labels, scores[:, None], 1)
    want_aucs, _, want_th = jmetrics.multi_label_roc(labels, scores[:, None], 1)
    assert aucs == want_aucs and th == want_th
    if len(np.unique(labels)) == 2:
        assert metrics.five_scores(labels, scores) == \
            jmetrics.five_scores(labels, scores)


def test_multiclass_metrics_match_jax():
    rng = np.random.default_rng(1)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
    scores = rng.random((40, 3)).astype(np.float32)
    got = metrics.multi_label_roc(labels, scores, 3)
    want = jmetrics.multi_label_roc(labels, scores, 3)
    assert got[0] == want[0] and got[2] == want[2]
    preds = metrics.binarize(scores, got[2])
    np.testing.assert_array_equal(preds, jmetrics.binarize(scores, want[2]))
    assert metrics.exact_match_score(labels, preds) == \
        jmetrics.exact_match_score(labels, preds)
    assert metrics.standalone_test_metrics(labels, preds, 3) == \
        jmetrics.standalone_test_metrics(labels, preds, 3)
    binary = (rng.random(30) > 0.4).astype(np.float64)
    votes = (rng.random(30) > 0.5).astype(np.float64)
    assert metrics.standalone_test_metrics(binary, votes, 1) == \
        jmetrics.standalone_test_metrics(binary, votes, 1)
    assert metrics.current_score(0.75, [0.5, 0.25]) == \
        jmetrics.current_score(0.75, [0.5, 0.25])


def test_kfold_indices_match_sklearn():
    for n in range(5, 61):
        want = list(KFold(n_splits=5, shuffle=True, random_state=42)
                    .split(np.arange(n)))
        got = schemes._kfold_indices(n, 5)
        assert len(got) == 5
        for (gt, ge), (wt, we) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(ge, we)


def test_feature_store_matches_jax(tmp_path):
    """CSV bytes, master-CSV parsing and the cached (shuffled) bags are the
    JAX package's (which reads and writes with pandas)."""
    rng = np.random.default_rng(2)
    entries = []
    for i in range(4):
        feats = rng.standard_normal((5 + i, 6)).astype(np.float32)
        ours, theirs = str(tmp_path / f"a{i}.csv"), str(tmp_path / f"b{i}.csv")
        feature_store.write_bag_csv(feats, ours)
        jfs.write_bag_csv(feats, theirs)
        with open(ours) as f1, open(theirs) as f2:
            assert f1.read() == f2.read()
        entries.append((ours, i % 2))
    master = str(tmp_path / "m.csv")
    with open(master, "w") as f:
        f.write("0,label\n" + "".join(f"{p},{y}\n" for p, y in entries))
    assert feature_store.read_master_csv(master) == jfs.read_master_csv(master)
    ours = feature_store.BagCache(str(tmp_path / "c1"))
    theirs = jfs.BagCache(str(tmp_path / "c2"))
    got = ours.load_all(ours.build(entries, 2, seed=3))
    want = theirs.load_all(theirs.build(entries, 2, seed=3))
    for g, w in zip(got, want):
        assert g.name == w.name
        np.testing.assert_array_equal(g.feats, w.feats)
        np.testing.assert_array_equal(g.label, w.label)


def test_checkpoints_round_trip(tmp_path):
    """save_mil_pth loads back with the port's and the JAX package's
    loaders; the train state survives a crash between its two renames."""
    params = jax.tree.map(np.asarray, jdsmil.init_params(
        jax.random.PRNGKey(0), jdsmil.DSMILConfig(feats_size=12, num_classes=2)))
    model = DSMIL(torch_ckpt.dsmil_config_from_state_dict(
        from_jax.dsmil_state_dict(params)), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params))
    path = str(tmp_path / "w.pth")
    torch_ckpt.save_mil_pth(model, path)
    back, cfg, name = torch_ckpt.load_mil_pth(path, CPU)
    assert name == "dsmil" and cfg.feats_size == 12 and cfg.num_classes == 2
    jparams, _, _ = jckpt.load_mil_pth(path)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="schema"):
        torch_ckpt.save_mil_pth(model, path, "abmil")

    state = str(tmp_path / "state")
    native_ckpt.save_train_state(state, {"p": torch.ones(2)}, meta={"e": 1})
    native_ckpt.save_train_state(state, {"p": torch.full((2,), 2.0)},
                                 meta={"e": 2})
    assert not os.path.exists(state + ".prev")
    os.rename(state, state + ".prev")  # a crash between the two renames
    st, meta = native_ckpt.load_train_state(state)
    assert meta == {"e": 2} and torch.equal(st["p"], torch.full((2,), 2.0))
    native_ckpt.save_train_state(state, {"p": torch.zeros(2)}, meta={"e": 3})
    st, meta = native_ckpt.load_train_state(state)
    assert meta == {"e": 3} and not os.path.exists(state + ".prev")


def _cohort(seed=0):
    rng = np.random.default_rng(seed)
    jbags = make_separable_bags(rng, num_bags=15, feats=16, signal=6.0,
                                pos_inst_frac=0.5, mean_instances=12)
    return jbags, [Bag(b.feats, b.label, b.name) for b in jbags]


def _jax_init(self, generator):
    """The JAX init of key ``generator.initial_seed()`` (the scheme's
    ``cfg.seed + fold``), carried over through from_jax."""
    params = jdsmil.init_params(
        jax.random.PRNGKey(generator.initial_seed()),
        jdsmil.DSMILConfig(feats_size=self.cfg.feats_size,
                           num_classes=self.cfg.num_classes))
    model = DSMIL(self.cfg, self.device)
    model.load_state_dict(from_jax.dsmil_state_dict(
        jax.tree.map(np.asarray, params)))
    return model, self.make_optimizer(model)


@pytest.mark.parametrize("scheme", ["run_5fold_cv", "run_5time_tvt",
                                    "run_5fold_cv_standalone_test"])
def test_scheme_matches_jax(monkeypatch, scheme):
    """Both packages' scheme on one cohort, the port's per-fold init
    replaced by the JAX init of the same key: equal accuracies, AUCs within
    1e-6, thresholds within 1e-4."""
    jbags, pbags = _cohort()
    kw = dict(feats_size=16, num_classes=1, num_epochs=2, lr=1e-3,
              stop_epochs=2, verbose=False, seed=0)
    want = getattr(jschemes, scheme)(jbags, jschemes.WSITrainConfig(**kw),
                                     log=lambda s: None)
    monkeypatch.setattr(BagTrainer, "init", _jax_init)
    got = getattr(schemes, scheme)(pbags,
                                   schemes.WSITrainConfig(**kw, device=CPU),
                                   log=lambda s: None)
    if scheme == "run_5time_tvt":
        for g, w in zip(got["iterations"], want["iterations"]):
            assert g["val_acc"] == w["val_acc"] and g["test_acc"] == w["test_acc"]
            np.testing.assert_allclose(g["val_aucs"], w["val_aucs"], atol=1e-6)
            np.testing.assert_allclose(g["test_aucs"], w["test_aucs"], atol=1e-6)
    else:
        assert [f["acc"] for f in got["folds"]] == \
            [f["acc"] for f in want["folds"]]
        np.testing.assert_allclose([f["aucs"] for f in got["folds"]],
                                   [f["aucs"] for f in want["folds"]],
                                   atol=1e-6)
        np.testing.assert_allclose([f["thresholds"] for f in got["folds"]],
                                   [f["thresholds"] for f in want["folds"]],
                                   atol=1e-4)
    if scheme == "run_5fold_cv_standalone_test":
        assert got["final"] == want["final"]
    else:
        assert got["mean_accuracy"] == want["mean_accuracy"]
        np.testing.assert_allclose(got["mean_auc"], want["mean_auc"],
                                   atol=1e-6)


def test_fingerprint_is_the_jax_string():
    for kw in ({}, {"use_device_store": False, "eval_interval": 3},
               {"lr": 5e-4, "average": True, "dropout_patch": 0.25}):
        for scheme in ("5-fold-cv", "5-fold-cv-standalone-test"):
            assert schemes._cfg_fingerprint(schemes.WSITrainConfig(**kw),
                                            scheme) == \
                jschemes._cfg_fingerprint(jschemes.WSITrainConfig(**kw), scheme)


def test_resume_from_markers_and_scale_out_raises(tmp_path):
    _, pbags = _cohort(1)
    cfg = schemes.WSITrainConfig(feats_size=16, num_classes=1, num_epochs=2,
                                 lr=1e-3, stop_epochs=2, verbose=False,
                                 resume=True, device=CPU)
    save_dir = str(tmp_path / "w")
    out1 = schemes.run_5fold_cv(pbags, cfg, log=lambda s: None,
                                save_dir=save_dir)
    for ext in (".pth", ".json", ".done.json"):
        assert len(glob.glob(os.path.join(save_dir, f"fold_?{ext}"))) == 5
    logs = []
    out2 = schemes.run_5fold_cv(pbags, cfg, log=logs.append, save_dir=save_dir)
    assert sum("Resuming fold" in line for line in logs) == 5
    assert out2["mean_accuracy"] == out1["mean_accuracy"]
    other = schemes.WSITrainConfig(**{**cfg.__dict__, "lr": 5e-4})
    logs = []
    schemes.run_5fold_cv_standalone_test(pbags, other, log=logs.append,
                                         save_dir=save_dir)
    assert not any("Resuming fold" in line for line in logs)
    assert len(glob.glob(os.path.join(save_dir, "test", "*.pth"))) == 5
    # scale-out, in one spawned gloo world of 2: inst_shard 2 equals the
    # single-device run (the JAX package's
    # test_run_5fold_cv_inst_sharded_parity), data_parallel 2 (another
    # optimisation, no parity) trains all 5 folds; rank 0 alone logs and
    # writes
    kw = {k: v for k, v in cfg.__dict__.items() if k != "device"}
    runs = [({**kw, "inst_shard": 2}, str(tmp_path / "inst")),
            ({**kw, "data_parallel": 2}, str(tmp_path / "dp"))]
    ranks = util.run_world(2, util.schemes_runs, runs,
                           [(b.feats, b.label, b.name) for b in pbags],
                           tmp=tmp_path)
    for rank, results in enumerate(ranks):
        (inst, inst_log), (dp, dp_log) = results
        assert [f["acc"] for f in inst["folds"]] == \
            [f["acc"] for f in out1["folds"]]
        np.testing.assert_allclose([f["aucs"] for f in inst["folds"]],
                                   [f["aucs"] for f in out1["folds"]],
                                   atol=1e-3)
        np.testing.assert_allclose([f["thresholds"] for f in inst["folds"]],
                                   [f["thresholds"] for f in out1["folds"]],
                                   atol=1e-3)
        assert inst["mean_accuracy"] == out1["mean_accuracy"]
        assert len(dp["folds"]) == 5 and np.isfinite(dp["mean_accuracy"])
        assert (len(inst_log) > 0 and len(dp_log) > 0) == (rank == 0)
    for sub in ("inst", "dp"):
        for ext in (".pth", ".json", ".done.json"):
            assert len(glob.glob(str(tmp_path / sub / f"fold_?{ext}"))) == 5


def test_mid_fold_state_resume_is_exact(tmp_path, monkeypatch):
    """A crash after the 2nd eval boundary's state save resumes on the
    uninterrupted trajectory, bitwise (params, best, thresholds)."""
    _, pbags = _cohort(2)
    cfg = schemes.WSITrainConfig(feats_size=16, num_classes=1, num_epochs=4,
                                 lr=1e-3, stop_epochs=4, verbose=False,
                                 resume=True, fold_state_every=1,
                                 dropout_patch=0.3, device=CPU)
    trainer = schemes._make_trainer(cfg)
    tr, te = pbags[:14], pbags[14:]
    fp = schemes._cfg_fingerprint(cfg, "5-fold-cv")

    def run(state_dir, log=lambda s: None):
        return schemes.train_fold(trainer, tr, te, cfg,
                                  np.random.default_rng(3),
                                  torch.Generator().manual_seed(1), log,
                                  state_dir=state_dir, state_fp=fp)

    straight = run(str(tmp_path / "s1"))
    save = native_ckpt.save_train_state
    calls = {"n": 0}

    def crash(path, state, *, meta=None):
        save(path, state, meta=meta)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(native_ckpt, "save_train_state", crash)
    with pytest.raises(KeyboardInterrupt):
        run(str(tmp_path / "s2"))
    monkeypatch.setattr(native_ckpt, "save_train_state", save)
    logs = []
    resumed = run(str(tmp_path / "s2"), logs.append)
    assert any("Resuming fold mid-run at epoch 3" in line for line in logs)
    assert resumed["acc"] == straight["acc"]
    assert resumed["thresholds"] == straight["thresholds"]
    for k, v in straight["params"].items():
        assert torch.equal(resumed["params"][k], v), k


def test_train_wsi_cli(tmp_path, monkeypatch, capsys):
    """python -m tpumil_torch.cli.train_wsi on synthetic CSVs, on the CPU:
    the reference's outputs under save_root/<date>/."""
    _, pbags = _cohort(3)
    root = tmp_path / "datasets" / "synth"
    rows = []
    for i, bag in enumerate(pbags):
        path = str(root / f"c{int(bag.label[0])}" / f"b{i}.csv")
        feature_store.write_bag_csv(bag.feats, path)
        rows.append(f"{path},{int(bag.label[0])}")
    with open(root / "synth.csv", "w") as f:
        f.write("0,label\n" + "\n".join(rows) + "\n")
    monkeypatch.chdir(tmp_path)
    assert train_wsi.main(["--device", "cpu", "--dataset", "synth",
                           "--num_classes", "1", "--feats_size", "16",
                           "--num_epochs", "2", "--lr", "1e-3"]) == 0
    out = capsys.readouterr().out
    assert "Final results: Mean Accuracy" in out and "device: cpu" in out
    (day,) = os.listdir(tmp_path / "weights")
    save_dir = tmp_path / "weights" / day
    assert len(glob.glob(str(save_dir / "fold_?.pth"))) == 5
    with open(save_dir / "fold_0.json") as f:
        assert len(json.load(f)) == 1
    model, cfg, _ = torch_ckpt.load_mil_pth(str(save_dir / "fold_0.pth"), CPU)
    assert cfg.feats_size == 16 and cfg.num_classes == 1
    with pytest.raises(ValueError):
        train_wsi.main(["--device", "cpu", "--model", "no-such-model",
                        "--dataset", "synth"])
    # --inst_shard 2 starts 2 gloo workers and writes the plain run's files
    out = util.run_cli("tpumil_torch.cli.train_wsi", [
        "--device", "cpu", "--dataset", "synth", "--num_classes", "1",
        "--feats_size", "16", "--num_epochs", "2", "--lr", "1e-3",
        "--inst_shard", "2", "--save_root", "sharded", "--cache_dir",
        "sharded_cache"], cwd=tmp_path)
    assert "starting 2 workers on cpu" in out
    assert out.count("Final results: Mean Accuracy") == 1
    sharded = tmp_path / "sharded" / day
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(save_dir))
    for k in range(5):
        for name in (f"fold_{k}.json", f"fold_{k}.done.json"):
            with open(save_dir / name) as f, open(sharded / name) as g:
                want, got = json.load(f), json.load(g)
            if name.endswith(".done.json"):
                assert got["acc"] == want["acc"]
                assert got["fingerprint"] == want["fingerprint"]
                want, got = want["thresholds"], got["thresholds"]
            np.testing.assert_allclose(got, want, atol=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_wsi.main(["--device", "cuda", "--dataset", "synth"])


def test_cli_flags_match_jax():
    """The JAX CLI's flag surface, with cuda in place of tpu."""
    from tpumil.cli import train_wsi as jcli

    def flags(mod):
        import argparse

        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main([]) if mod is jcli else mod.parse_args([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    port, jax_flags = flags(train_wsi), flags(jcli)
    # the one difference: the port's device is the card unless asked
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags
    assert sys.modules["tpumil_torch.cli.train_wsi"] is train_wsi


def test_train_wsi_defaults_to_the_card(tmp_path, monkeypatch):
    """No --device: the card, which raises without one before any file is
    read; a WSITrainConfig without a device trains on the card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    assert train_wsi.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_wsi.main(["--dataset", "synth"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schemes._make_trainer(schemes.WSITrainConfig(feats_size=16,
                                                     num_classes=1))
