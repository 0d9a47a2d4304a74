"""The port's classic-MIL benchmark path (tpumil_torch/data/mil_bench.py,
train/schemes.run_mil_cv, cli/train_mil.py) against the JAX package's, on
tests/data/musk1_mini.svm (30 bags of 4-17 instances, K = 166) and the same
seeds. Bars: equal fold accuracies, logged train/test losses within 1e-4."""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from tpumil.cli import train_mil as jcli
from tpumil.data import mil_bench as jmb
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.models.registry import get_model as jget_model
from tpumil.train import schemes as jschemes
from tpumil_torch.cli import train_mil
from tpumil_torch.data import mil_bench
from tpumil_torch.io import from_jax
from tpumil_torch.models.registry import get_model
from tpumil_torch.train import schemes
from tpumil_torch.train.trainer import BagTrainer

import torch_parallel_util as util

CPU = torch.device("cpu")
MUSK = os.path.join(os.path.dirname(__file__), "data", "musk1_mini.svm")


def _same_bags(got, want):
    assert [b.name for b in got] == [b.name for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feats, w.feats)
        np.testing.assert_array_equal(g.label, w.label)


def test_parse_mil_file_matches_jax(tmp_path):
    """The header skip, the label clip, truncation and zero fill."""
    for num_feats in (166, 100, None):
        _same_bags(mil_bench.parse_mil_file(MUSK, num_feats),
                   jmb.parse_mil_file(MUSK, num_feats))
    path = str(tmp_path / "short.svm")
    with open(path, "w") as f:
        f.write("h:0:0 1:0\n0:3:2 1:0.5 2:-1\n1:3:2 1:2\n\n2:1:-1 1:3 x 3:4\n")
    for num_feats in (2, 6):
        _same_bags(mil_bench.parse_mil_file(path, num_feats),
                   jmb.parse_mil_file(path, num_feats))
        _same_bags(mil_bench.parse_mil_file(path, num_feats, skip_header=False),
                   jmb.parse_mil_file(path, num_feats, skip_header=False))


def test_split_pos_weight_and_shuffle_match_jax():
    for n in (7, 30, 31):
        items = list(range(n))
        for fold in (2, 3, 7):
            for k in range(fold):
                assert mil_bench.cross_validation_split(items, fold, k) == \
                    jmb.cross_validation_split(items, fold, k)
    with pytest.raises(ValueError, match="exceeds"):
        mil_bench.cross_validation_split(list(range(3)), 4, 0)
    pbags, jbags = mil_bench.parse_mil_file(MUSK, 166), jmb.parse_mil_file(MUSK, 166)
    for lo, hi in ((0, 30), (3, 17), (10, 30)):
        assert mil_bench.compute_pos_weight(pbags[lo:hi]) == \
            jmb.compute_pos_weight(jbags[lo:hi])
    for seed in (0, 1, 5):
        for fold in (3, 10):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            _same_bags(mil_bench.shuffle_with_class_coverage(pbags, fold, r1),
                       jmb.shuffle_with_class_coverage(jbags, fold, r2))
            assert r1.integers(1 << 62) == r2.integers(1 << 62)


def _jax_init(self, generator):
    """The JAX init of key ``generator.initial_seed()`` (``cfg.seed + 1000
    * fold``) for the trainer's model, carried over through from_jax."""
    params = jget_model(self.model).init_params(
        jax.random.PRNGKey(generator.initial_seed()),
        JCfg(feats_size=self.cfg.feats_size, num_classes=self.cfg.num_classes))
    net = get_model(self.model)(self.cfg, self.device)
    net.load_state_dict(from_jax.mil_state_dict(
        jax.tree.map(np.asarray, params), self.model))
    return net, self.make_optimizer(net)


_LOSSES = re.compile(r"train_loss (\S+) test_loss (\S+)")


@pytest.mark.parametrize("model", ["dsmil", "abmil", "meanpool", "maxpool"])
def test_run_mil_cv_matches_jax(monkeypatch, model):
    """Both packages' run_mil_cv on musk1_mini, 3 folds x 2 epochs, the
    port's fold init replaced by the JAX init of the same key: equal fold
    accuracies and log lines, losses within 1e-4."""
    _cv_matches_jax(monkeypatch, dict(num_feats=166, cv_fold=3,
                                      num_epochs=2, model=model))


def test_run_mil_cv_without_device_store_matches_jax(monkeypatch):
    """use_device_store=False keeps the bags on the host in both packages
    (the port builds no DeviceBagStore): the same folds, accuracies and log
    lines as JAX's."""
    def no_store(*args, **kwargs):
        raise AssertionError("use_device_store=False built a device store")

    monkeypatch.setattr(schemes, "DeviceBagStore", no_store)
    _cv_matches_jax(monkeypatch, dict(num_feats=166, cv_fold=3, num_epochs=2,
                                      use_device_store=False))


def _cv_matches_jax(monkeypatch, kw):
    want_log, got_log = [], []
    want = jschemes.run_mil_cv(jmb.parse_mil_file(MUSK, 166),
                               jschemes.MILBenchConfig(**kw),
                               log=want_log.append)
    monkeypatch.setattr(BagTrainer, "init", _jax_init)
    got = schemes.run_mil_cv(mil_bench.parse_mil_file(MUSK, 166),
                             schemes.MILBenchConfig(**kw, device=CPU),
                             log=got_log.append)
    assert got[2] == want[2] and got[:2] == want[:2]
    assert len(got_log) == len(want_log) == 3 * 3 + 1
    for g, w in zip(got_log, want_log):
        mg, mw = _LOSSES.search(g), _LOSSES.search(w)
        if mw is None:
            assert g == w
            continue
        np.testing.assert_allclose([float(x) for x in mg.groups()],
                                   [float(x) for x in mw.groups()], atol=1e-4)
        assert g[mg.end():] == w[mw.end():] and g[:mg.start()] == w[:mw.start()]


def test_run_mil_cv_checks_init_and_scale_out(tmp_path):
    """The JAX package's init checks and messages; inst_shard 2 in a
    spawned gloo world of 2 trains as JAX's inst_shard 2 does; the
    torch-default init trains dsmil, from a permutation as the bag order."""
    bags = mil_bench.parse_mil_file(MUSK, 166)
    cfg = dict(num_feats=166, cv_fold=3, num_epochs=1, verbose=False,
               device=CPU)
    for bad, msg in (({"init": "torch_default", "model": "abmil"},
                      "only implemented for model='dsmil'"),
                     ({"init": "default"}, "init must be")):
        with pytest.raises(ValueError, match=msg):
            schemes.run_mil_cv(bags, schemes.MILBenchConfig(**cfg, **bad))
        with pytest.raises(ValueError, match=msg):
            jschemes.run_mil_cv(jmb.parse_mil_file(MUSK, 166),
                                jschemes.MILBenchConfig(num_feats=166, **bad))
    # the folds' inits are JAX's (keys seed + 1000 * fold), as in
    # _cv_matches_jax; rank 0 alone logs
    kw = dict(num_feats=166, cv_fold=3, num_epochs=1, inst_shard=2)
    want_log = []
    want = jschemes.run_mil_cv(jmb.parse_mil_file(MUSK, 166),
                               jschemes.MILBenchConfig(**kw),
                               log=want_log.append)
    inits = {k * 1000: from_jax.mil_state_dict(jax.tree.map(
        np.asarray, jget_model("dsmil").init_params(
            jax.random.PRNGKey(k * 1000), JCfg(166, 1))), "dsmil")
        for k in range(3)}
    ranks = util.run_world(2, util.mil_run, kw, MUSK, 166, inits,
                           tmp=tmp_path)
    for rank, (got, got_log) in enumerate(ranks):
        assert got[2] == want[2] and got[:2] == want[:2]
        assert len(got_log) == (len(want_log) if rank == 0 else 0)
    for g, w in zip(ranks[0][1], want_log):
        mg, mw = _LOSSES.search(g), _LOSSES.search(w)
        if mw is None:
            assert g == w
            continue
        np.testing.assert_allclose([float(x) for x in mg.groups()],
                                   [float(x) for x in mw.groups()], atol=1e-4)
    with pytest.raises(ValueError, match="permutation"):
        schemes.run_mil_cv(bags, schemes.MILBenchConfig(**cfg),
                           permutation=[0] * len(bags))
    mean, std, accs = schemes.run_mil_cv(
        bags, schemes.MILBenchConfig(**cfg, init="torch_default"),
        log=lambda s: None, permutation=np.random.default_rng(2).permutation(
            len(bags)).tolist())
    assert len(accs) == 3 and all(0.0 <= a <= 1.0 for a in accs)


def test_cli_flags_match_jax():
    """The JAX CLI's flag surface, with cuda in place of auto|cpu|tpu."""
    import argparse

    def flags(mod):
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

    port, jax_flags = flags(train_mil), flags(jcli)
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags
    assert sys.modules["tpumil_torch.cli.train_mil"] is train_mil


def test_train_mil_cli(tmp_path, monkeypatch, capsys):
    """python -m tpumil_torch.cli.train_mil on the CPU; the card by
    default, which raises without one before any file is read; unknown
    models and --inst_shard for a model without a sharded forward raise
    before the file is read (and before any worker starts) too."""
    monkeypatch.chdir(tmp_path)
    assert train_mil.main(["--device", "cpu", "--data_file", MUSK,
                           "--num_feats", "166", "--cv_fold", "3",
                           "--num_epoch", "1", "--model", "maxpool"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and f"Dataset: {MUSK}" in out
    assert "Cross validation accuracy mean" in out
    assert out.count("optimal accuracy") == 3
    missing = str(tmp_path / "absent.svm")
    for argv, exc in ((["--model", "no-such-model"], ValueError),
                      (["--model", "abmil", "--inst_shard", "2"],
                       NotImplementedError)):
        with pytest.raises(exc):
            train_mil.main(["--device", "cpu", "--data_file", missing,
                            "--num_feats", "166"] + argv)
    with pytest.raises(SystemExit):
        train_mil.main(["--device", "cpu", "--data_file", MUSK])
    with pytest.raises(SystemExit):
        train_mil.main(["--device", "cpu", "--datasets", "mnist"])
    with pytest.raises(FileNotFoundError, match="mil_dataset"):
        train_mil.main(["--device", "cpu", "--datasets", "fox"])
    assert train_mil.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mil.main(["--data_file", missing, "--num_feats", "166"])
