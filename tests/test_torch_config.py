"""The port's typed pipeline config (tpumil_torch/io/config.py) against the
JAX package's (tpumil/io/config.py): the same YAML keys, defaults, resolved
YAML and refusals. The one difference: the port's sections carry a runtime
``device`` (WSITrainConfig, MILBenchConfig) that is not a YAML key, so it
never reaches the resolved YAML and a file that sets it is refused, as the
JAX package refuses it."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from tpumil.io import config as jconfig
from tpumil_torch.data import tiler
from tpumil_torch.io import config
from tpumil_torch.utils import native

PARTIAL = ("dataset: c16\n"
           "magnifications: [0, 2]\n"
           "train:\n  num_classes: 1\n  lr: 0.0002\n  use_device_store: false\n"
           "tiler:\n  tile_size: 256\n  native_encode: true\n"
           "simclr:\n  batch_size: 8\n  grad_cache_microbatch: 4\n"
           "embedder:\n  precision: f32x\n  space_to_depth: false\n"
           "mil_bench:\n  num_feats: 166\n  use_device_store: false\n"
           "inference:\n  thresholds: [0.3]\n  class_names: [tumor]\n")


def test_sections_have_the_jax_fields():
    """Every section's YAML keys and defaults are the JAX package's."""
    for name, cls in config.PipelineConfig._SECTIONS.items():
        jcls = jconfig.PipelineConfig._SECTIONS[name]
        want = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        got = [(f.name, f.default) for f in dataclasses.fields(cls)
               if f.name not in config.RUNTIME_FIELDS]
        assert got == want, name


@pytest.mark.parametrize("text", ["", "dataset: demo\n", PARTIAL])
def test_resolved_yaml_equals_jax(tmp_path, text):
    """The defaults and partial files resolve to the same dict and the same
    resolved YAML bytes in both packages, and the port's round-trips."""
    src = tmp_path / "exp.yaml"
    src.write_text(text)
    got = config.PipelineConfig.from_yaml(str(src))
    want = jconfig.PipelineConfig.from_yaml(str(src))
    assert got.to_dict() == want.to_dict()
    got.train.device = torch.device("cpu")  # what the pipeline sets
    got.to_yaml(str(tmp_path / "port.yaml"))
    want.to_yaml(str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_bytes() == \
        (tmp_path / "jax.yaml").read_bytes()
    again = config.PipelineConfig.from_yaml(str(tmp_path / "port.yaml"))
    assert again.to_dict() == got.to_dict()
    if text == PARTIAL:
        assert got.magnifications == (0, 2) and got.train.lr == 2e-4
        assert got.train.num_epochs == 50  # default preserved
        assert got.mil_bench.num_feats == 166


@pytest.mark.parametrize("text", ["train:\n  learning_rate: 0.1\n",
                                  "datast: x\n",
                                  "train:\n  device: cpu\n",
                                  "mil_bench:\n  num_feats: 3\n  device: cpu\n",
                                  "embedder:\n  dtype: bf16\n"])
def test_unknown_keys_rejected_as_jax(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match="unknown") as got:
        config.PipelineConfig.from_yaml(str(path))
    with pytest.raises(ValueError) as want:
        jconfig.PipelineConfig.from_yaml(str(path))
    assert str(got.value) == str(want.value)


def test_yaml_is_imported_only_for_a_file():
    """The card's machine may lack PyYAML: the module imports it only in
    from_yaml and to_yaml."""
    tree = ast.parse(open(config.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names}
    names |= {n.module for n in top if isinstance(n, ast.ImportFrom)}
    assert "yaml" not in names
    inner = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert "yaml" in inner


def test_native_encode_is_honoured(tmp_path, monkeypatch):
    """tiler.native_encode from a JAX YAML writes full-size JPEG tiles
    through native.encode_jpeg where the binding is built, and through PIL
    for other formats, sizes, or without the binding."""
    path = tmp_path / "exp.yaml"
    path.write_text(PARTIAL)
    cfg = config.PipelineConfig.from_yaml(str(path)).tiler
    assert cfg.native_encode and cfg.format == "jpeg"
    tile = np.random.default_rng(0).integers(0, 256, (256, 256, 3),
                                             dtype=np.uint8)
    calls = []
    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setattr(native, "encode_jpeg",
                        lambda t, p, q: calls.append((t.shape, p, q)))
    tiler._save_tile(tile, str(tmp_path / "a" / "0_0.jpeg"), cfg)
    assert calls == [((256, 256, 3), str(tmp_path / "a" / "0_0.jpeg"), 70)]
    tiler._save_tile(tile[:200], str(tmp_path / "a" / "0_1.jpeg"), cfg)
    png = dataclasses.replace(cfg, format="png")
    tiler._save_tile(tile, str(tmp_path / "a" / "0_2.png"), png)
    off = dataclasses.replace(cfg, native_encode=False)
    tiler._save_tile(tile, str(tmp_path / "a" / "0_3.jpeg"), off)
    assert len(calls) == 1
    monkeypatch.setattr(native, "available", lambda: False)
    tiler._save_tile(tile, str(tmp_path / "a" / "0_4.jpeg"), cfg)
    assert len(calls) == 1
    for name in ("0_1.jpeg", "0_2.png", "0_3.jpeg", "0_4.jpeg"):
        assert os.path.getsize(tmp_path / "a" / name) > 0
