"""The port's SimCLR CLI (tpumil_torch/cli/simclr_train.py) against the JAX
package's (tpumil/cli/simclr_train.py): end to end on the CPU with the
grad-cache step, the manifest byte-equal to pandas', the config YAML, the
flags, and the refusals.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from test_torch_testing_cli import _flags
from tpumil.cli import simclr_train as jax_cli
from tpumil_torch.cli import simclr_train
from tpumil_torch.models import embedder


def _tree(root, n=16, size=32):
    bag = root / "WSI" / "toy" / "single" / "cls" / "slide0"
    bag.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)) \
            .save(str(bag / f"0_{i}.jpeg"))


def _argv(tmp_path, *extra):
    return ["--dataset", "toy", "--wsi_root", str(tmp_path / "WSI"),
            "--batch_size", "8", "--num_workers", "2", "--run_dir",
            str(tmp_path / "run"), "--device", "cpu", *extra]


@pytest.mark.parametrize("size", [32, 64])
def test_cli_grad_cache_end_to_end(tmp_path, monkeypatch, capsys, size):
    """The reference's folder layout -> manifest -> trainer (grad-cache,
    microbatch 4) -> a model.pth that the embedder surgery loads; at 32^2
    the last stage's planes are 1x1 and normalize to 0, as in the JAX
    package."""
    _tree(tmp_path, size=size)
    monkeypatch.chdir(tmp_path)
    rc = simclr_train.main(_argv(tmp_path, "--grad_cache", "4", "--epochs",
                                 "1", "--input_size", str(size), "--config",
                                 ""))
    assert rc == 0
    assert "best valid loss" in capsys.readouterr().out
    with open(tmp_path / "all_patches.csv") as f:
        assert f.read().splitlines() == ["0"] + sorted(
            str(p) for p in (tmp_path / "WSI").rglob("*.jpeg"))
    ckpt = tmp_path / "run" / "checkpoints" / "model.pth"
    emb = embedder.load_simclr_checkpoint(str(ckpt), embedder.EmbedderConfig(
        num_classes=1), torch.device("cpu"))
    with torch.no_grad():
        feats, _ = emb(torch.rand(2, size, size, 3))
    assert feats.shape == (2, 512) and torch.isfinite(feats).all()


def test_manifest_is_byte_equal_to_pandas(tmp_path):
    paths = ["a/b.jpeg", "with,comma.jpeg", 'with"quote.jpeg', "plain"]
    simclr_train.write_manifest(paths, str(tmp_path / "port.csv"))
    pd.DataFrame(paths).to_csv(str(tmp_path / "pandas.csv"), index=False)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pandas.csv").read_bytes()


def test_config_yaml_is_read_and_needs_pyyaml(tmp_path, monkeypatch):
    """Flags override the YAML; a YAML without PyYAML is an error, not an
    empty config."""
    _tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(
        "batch_size: 4\nepochs: 1\nmodel:\n  out_dim: 64\n"
        "dataset:\n  valid_size: 0.25\n")
    seen = {}
    monkeypatch.setattr(
        "tpumil_torch.train.simclr_trainer.SimCLRTrainer.fit",
        lambda self, paths, run_dir, **kw: seen.update(
            cfg=self.cfg, model_cfg=self.model_cfg) or {
            "best_valid_loss": 0.0, "checkpoint": "x"})
    argv = ["--dataset", "toy", "--wsi_root", str(tmp_path / "WSI"),
            "--device", "cpu", "--input_size", "32", "--epochs", "2"]
    assert simclr_train.main(argv) == 0
    assert (seen["cfg"].batch_size, seen["cfg"].epochs,
            seen["cfg"].valid_size, seen["model_cfg"].out_dim) == (4, 2, 0.25,
                                                                   64)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="needs PyYAML"):
        simclr_train.main(argv)


def test_cli_flags_match_jax():
    """The JAX CLI's flag surface and defaults, with cuda in place of
    auto."""
    port = _flags(lambda: simclr_train.parse_args([]))
    jax_flags = _flags(lambda: jax_cli.main([]))
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags


def test_cli_refusals(tmp_path, monkeypatch):
    """--data_parallel's refusals (JAX's take_devices and trainer
    messages); no --device is the card, which raises without one; all
    before any file is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="non-negative, got -1"):
        simclr_train.main(["--device", "cpu", "--data_parallel", "-1"])
    with pytest.raises(ValueError, match="batch_size 512 must be divisible "
                                         "by the data-parallel mesh size 3"):
        simclr_train.main(["--device", "cpu", "--data_parallel", "3"])
    assert simclr_train.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            simclr_train.main([])
    assert not os.listdir(tmp_path)


def test_prof_scalars_meter_and_trace_match_jax(tmp_path, monkeypatch):
    """utils/prof.py: ScalarLogger writes the JAX package's JSONL records,
    ThroughputMeter counts as its does, and trace writes a Chrome trace."""
    import json

    from tpumil.utils import prof as jprof
    from tpumil_torch.utils import prof

    monkeypatch.setattr(prof, "_summary_writer", lambda logdir: None)
    monkeypatch.setattr(prof, "WINDOW", 3)
    for name, logger in (
            ("jax", jprof.ScalarLogger(str(tmp_path / "jax"),
                                       tensorboard=False)),
            ("port", prof.ScalarLogger(str(tmp_path / "port")))):
        logger.log("train_loss", np.float32(2.5), 3)
        logger.log("validation_loss", 1.25, 0)
        logger.close()
    rows = {name: [{k: v for k, v in json.loads(line).items() if k != "time"}
                   for line in open(tmp_path / name / "scalars.jsonl")]
            for name in ("jax", "port")}
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2
    meter = prof.ThroughputMeter("patches")
    for _ in range(5):
        meter.add(8)
    assert meter.total == 40 and meter.rate > 0 and "patches/s" in str(meter)
    assert len(meter._events) == 3  # the window
    with prof.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with open(tmp_path / "trace" / prof.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
