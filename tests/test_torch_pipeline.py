"""The port's pipeline CLI, downloader and CLI listing
(tpumil_torch/cli/{pipeline,download,__main__}.py) against the JAX
package's: the same flags (``--device cuda|cpu`` the one difference), the
same up-front refusals before any stage runs, all five stages on the CPU at
the JAX end-to-end test's sizes, and a download from a local zip (nothing is
fetched)."""

import argparse
import glob
import json
import os
import runpy
import sys
import zipfile

import numpy as np
import pytest
import torch

from tpumil.cli import download as jdownload
from tpumil.cli import pipeline as jpipeline
from tpumil_torch.cli import download, pipeline

import torch_parallel_util as util


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


@pytest.mark.parametrize("ours,theirs", [(pipeline, jpipeline),
                                         (download, jdownload)])
def test_flags_match_jax(ours, theirs):
    """The JAX CLI's flags and defaults; the pipeline's --device is cuda in
    place of auto (and takes cuda|cpu), download has none."""
    got, want = _flags(lambda: ours.main([])), _flags(lambda: theirs.main([]))
    if ours is pipeline:
        assert (got.pop("device"), want.pop("device")) == ("cuda", "auto")
        assert [a.choices for a in pipeline.build_parser()._actions
                if a.dest == "device"] == [["cuda", "cpu"]]
    assert got == want


def _yaml(tmp_path, name, text):
    (tmp_path / name).write_text("dataset: demo\nmagnifications: [0]\n" + text)
    return name


# (yaml body, stages, message): the JAX pipeline's checks first, then the
# device probe of the embedding and train stages' fields (no card here, or
# one: fewer than 2, 4 or 8)
REFUSALS = [
    ("", "tile,resize", "unknown stage 'resize'"),
    ("embedder:\n  data_parallel: -2\n", "feats", ">= 0"),
    ("embedder:\n  batch_size: 8\n  data_parallel: 8\ninference:\n"
     "  batch_size: 12\n", "tile,simclr,feats,train,maps",
     "inference.batch_size 12"),
    ("embedder:\n  batch_size: 12\n  data_parallel: 8\n", "feats",
     "embedder.batch_size 12"),
    ("train:\n  inst_shard: 2\n  data_parallel: 2\n", "train",
     "mutually exclusive"),
    ("train:\n  inst_shard: -1\n", "train", "train.inst_shard must be >= 0"),
]
SCALE_OUT = [
    ("embedder:\n  batch_size: 8\n  data_parallel: 8\n", "feats",
     "embedder.data_parallel: requested 8 devices but only"),
    ("embedder:\n  data_parallel: 2\n", "maps",
     "embedder.data_parallel: requested 2 devices but only"),
    ("train:\n  inst_shard: 4\n", "train",
     "train.inst_shard: requested 4 devices but only"),
    ("train:\n  data_parallel: 2\n", "tile,train",
     "train.data_parallel: requested 2 devices but only"),
]


@pytest.mark.parametrize("body,stages,msg", REFUSALS + SCALE_OUT)
def test_refusals_before_any_stage(tmp_path, monkeypatch, capsys, body,
                                   stages, msg):
    """Each refusal exits 2 before the device is selected (no card needed
    for --device cuda) and before any stage runs or the run dir exists;
    the JAX pipeline's own checks give its message."""
    monkeypatch.chdir(tmp_path)
    name = _yaml(tmp_path, "exp.yaml", body)
    with pytest.raises(SystemExit) as exc:
        pipeline.main(["--config", name, "--stages", stages])
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert msg in err
    assert not os.path.exists("runs")
    if (body, stages, msg) in SCALE_OUT:
        return
    with pytest.raises(SystemExit):
        jpipeline.main(["--config", name, "--stages", stages, "--device",
                        "cpu"])
    assert capsys.readouterr().err.strip().splitlines()[-1] == err


@pytest.fixture
def pipeline_workdir(tmp_path, rng, monkeypatch):
    """tests/test_pipeline_e2e.py's slides and sizes: 3 + 3 two-page TIFFs
    of 256^2, 64^2 tiles, batch 8; one device (data_parallel 0)."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    for cls in ("tumor", "normal"):
        for i in range(3):
            img = np.full((256, 256, 3), 255, np.uint8)
            if cls == "tumor":
                img[:160, :160] = (rng.random((160, 160, 3)) * 180 + 20
                                   ).astype(np.uint8)
            else:
                tex = (rng.random((160, 160, 3)) * 60 + 120)
                tex[..., 1] += 40
                img[:160, :160] = np.clip(tex, 0, 255).astype(np.uint8)
            d = tmp_path / "WSI" / "demo" / cls
            d.mkdir(parents=True, exist_ok=True)
            pages = [Image.fromarray(img)]
            pages.append(pages[0].resize((128, 128)))
            pages[0].save(str(d / f"{cls}{i}.tif"), save_all=True,
                          append_images=pages[1:], description="|AppMag = 20|")
    (tmp_path / "exp.yaml").write_text(
        "dataset: demo\n"
        "magnifications: [0]\n"
        "tiler:\n  tile_size: 64\n"
        "simclr:\n  batch_size: 8\n  epochs: 1\n  input_size: 64\n"
        "  num_workers: 2\n"
        "embedder:\n  num_classes: 1\n  batch_size: 8\n  patch_size: 64\n"
        "  precision: f32\n  num_workers: 2\n"
        "train:\n  num_classes: 1\n  feats_size: 512\n  num_epochs: 3\n"
        "  stop_epochs: 2\n  lr: 0.002\n  verbose: false\n"
        "inference:\n  thresholds: [0.0]\n  num_workers: 2\n")
    return tmp_path


def test_pipeline_all_stages_on_cpu(pipeline_workdir):
    rc = pipeline.main(["--config", "exp.yaml",
                        "--stages", "tile,simclr,feats,train,maps",
                        "--device", "cpu"])
    assert rc == 0
    # every stage's artifacts exist
    assert glob.glob("WSI/demo/single/*/*/*.jpeg")
    assert os.path.exists("runs/demo/simclr/checkpoints/model.pth")
    assert os.path.exists("datasets/demo/demo.csv")
    assert len(glob.glob("datasets/demo/*/*.csv")) == 6
    assert glob.glob("runs/demo/weights/fold_*.pth")
    assert glob.glob("runs/demo/weights/test/mil_weights_fold_*.pth")
    assert len(glob.glob("runs/demo/maps/*.png")) == 6
    from tpumil_torch.io.config import PipelineConfig

    resolved = PipelineConfig.from_yaml("runs/demo/resolved_config.yaml")
    assert resolved.to_dict() == PipelineConfig.from_yaml("exp.yaml").to_dict()
    # the train stage again with train.inst_shard 2: two gloo workers read
    # the bag cache and train the single-device folds
    with open("exp.yaml") as f:
        body = f.read().replace("train:\n", "train:\n  inst_shard: 2\n")
    with open("sharded.yaml", "w") as f:
        f.write(body)
    out = util.run_cli("tpumil_torch.cli.pipeline", [
        "--config", "sharded.yaml", "--stages", "train", "--device", "cpu",
        "--run_root", "sharded"], cwd=os.getcwd())
    assert "starting 2 workers on cpu" in out and "pipeline done." in out
    plain, sharded = "runs/demo/weights", "sharded/demo/weights"
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(plain))
    for name in sorted(glob.glob(os.path.join(plain, "fold_?.done.json"))):
        with open(name) as f, open(name.replace(plain, sharded)) as g:
            want, got = json.load(f), json.load(g)
        assert got["acc"] == want["acc"]
        np.testing.assert_allclose(got["thresholds"], want["thresholds"],
                                   atol=1e-3)


def test_pipeline_defaults_to_the_card(pipeline_workdir):
    """No --device is the card: without one it raises once the config
    checks pass, before the run dir is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["--config", "exp.yaml", "--stages", "tile"])
    assert not os.path.exists("runs")


def test_download_from_a_local_zip(tmp_path, monkeypatch, capsys):
    """The JAX table of names, URLs and destinations; one entry swapped for
    a file:// zip is fetched, unzipped into its destination and removed."""
    assert download.DATASETS == jdownload.DATASETS
    src = tmp_path / "src.zip"
    with zipfile.ZipFile(src, "w") as z:
        z.writestr("mil/musk.svm", "0:0:1 1:0.5\n")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setitem(download.DATASETS, "local",
                        [(src.as_uri(), "local.zip", "datasets")])
    assert download.main(["--dataset", "local"]) == 0
    assert (work / "datasets" / "mil" / "musk.svm").read_text() == \
        "0:0:1 1:0.5\n"
    assert not (work / "local.zip").exists()
    assert "downloading local.zip" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        download.main(["--dataset", "nope"])
    assert exc.value.code == 2


def test_cli_listing(capsys, monkeypatch):
    """``python -m tpumil_torch.cli`` prints the listing of the port's 13
    entry points, each a module of the package."""
    monkeypatch.setattr(sys, "argv", ["tpumil_torch.cli"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("tpumil_torch.cli", run_name="__main__")
    assert exc.value.code == 0
    out = capsys.readouterr().out
    names = [line.split()[2].rsplit(".", 1)[1] for line in out.splitlines()
             if line.strip().startswith("python -m tpumil_torch.cli.")]
    assert len(names) == len(set(names)) == 13
    cli_dir = os.path.dirname(pipeline.__file__)
    assert sorted(names) == sorted(
        os.path.basename(p)[:-3] for p in glob.glob(os.path.join(cli_dir, "*.py"))
        if not os.path.basename(p).startswith("_"))
