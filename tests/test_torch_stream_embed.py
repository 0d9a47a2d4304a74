"""The one-pass slide -> features path of the port against the JAX package:
``embed_arrays``, ``embed_slide_streaming``, ``embed_slides_streaming``,
``embed_dataset_streaming`` (CSVs, ``.pos.csv`` sidecars, master CSV,
shards) and the ``slide_feats`` CLI, with the same embedder weights on both
sides (carried over by tpumil_torch/io/from_jax.py), on synthetic pyramidal
TIFFs written here.

Most slides are tiled at 128^2, where the stem takes the conv route; one
case tiles at 224^2, so the stream feeds the K5 stem's route (its plain
version on the CPU).
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.cli import slide_feats as jax_cli
from tpumil.data.tiler import TilerConfig as JaxTilerConfig
from tpumil.infer import features as jfeatures
from tpumil.infer import stream_embed as jstream
from tpumil.models import embedder as jemb
from tpumil_torch.cli import slide_feats as cli
from tpumil_torch.data import feature_store
from tpumil_torch.data.slide import DeepZoom, magnification_plan, open_slide
from tpumil_torch.data.tiler import TilerConfig
from tpumil_torch.infer import features, stream_embed
from tpumil_torch.io import from_jax
from tpumil_torch.models import embedder, resnet
from tpumil_torch.ops import stem as stem_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TILE = 128
BATCH = 4
# features agree to 1e-4 in memory (test_in_pallas.py's forward bar); the
# CSVs keep %.4f, so one last-digit flip on top
TOL = dict(rtol=1e-4, atol=1e-4)
CSV_ATOL = 1.5e-4


def _slide(root, name, cls, seed, size=512, tissue=300):
    """A 2-level pyramidal TIFF, white but for a textured top-left block
    and a thin textured strip on the right edge (ragged tiles when the size
    is not a multiple of the tile)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    img[:tissue, :tissue] = (rng.random((tissue, tissue, 3)) * 200
                             + 20).astype(np.uint8)
    img[:, -40:] = (rng.random((size, 40, 3)) * 200 + 20).astype(np.uint8)
    pages = [Image.fromarray(img)]
    pages.append(pages[0].resize((size // 2, size // 2)))
    path = os.path.join(root, "WSI", "demo", cls, f"{name}.tif")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pages[0].save(path, save_all=True, append_images=pages[1:],
                  description="Aperio Fake |AppMag = 20|")
    return path


@pytest.fixture(scope="module")
def weights():
    """The JAX embedder and the port's, on the same weights."""
    cfg_j = jemb.EmbedderConfig(num_classes=1, compute_dtype=jnp.float32,
                                precision="highest")
    params = jemb.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg = embedder.EmbedderConfig(num_classes=1, precision="f32")
    model = embedder.Embedder(cfg, CPU)
    model.load_state_dict(from_jax.embedder_state_dict(params, cfg.resnet_cfg),
                          strict=True)
    return (params, cfg_j), model


@pytest.fixture(scope="module")
def extractors(weights):
    (params, cfg_j), model = weights
    return (jfeatures.FeatureExtractor(params, cfg_j, BATCH, TILE),
            features.FeatureExtractor(model, BATCH, TILE))


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slides"))
    return root, [_slide(root, f"s{i}", ("tumor", "normal")[i % 2], i,
                         size=(512, 500, 420)[i])
                  for i in range(3)]


def _cfgs(tile=TILE):
    kw = dict(tile_size=tile, workers=2, base_mag=20, objective=20)
    return TilerConfig(**kw), JaxTilerConfig(**kw)


def _assert_same_result(got, want):
    (f, p, s), (jf, jp, js) = got, want
    np.testing.assert_array_equal(p, jp)
    assert f.shape == jf.shape == (len(p), 512)
    assert np.abs(jf).max() > 0.1  # a real comparison
    np.testing.assert_allclose(f, jf, **TOL)
    for field in ("tiles_total", "tiles_kept", "errors"):
        assert getattr(s, field) == getattr(js, field), field


def test_embed_arrays_matches_jax(extractors):
    jex, pex = extractors
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (BATCH, TILE, TILE, 3), np.uint8)
    got = pex.embed_arrays(u8)
    np.testing.assert_allclose(got, jex.embed_arrays(u8), **TOL)
    f32 = u8.astype(np.float32) / 255.0
    np.testing.assert_allclose(pex.embed_arrays(f32), jex.embed_arrays(f32),
                               **TOL)
    np.testing.assert_allclose(pex.embed_arrays(f32), got, rtol=0, atol=1e-6)
    zeros = pex.embed_arrays(np.zeros((BATCH, TILE, TILE, 3), np.uint8))
    assert np.all(zeros == 0)  # padded tiles: instance norm gives 0, not NaN


def test_embed_slide_streaming_matches_jax(extractors, slides):
    """Features, positions and stats of one slide; the last batch is
    padded; each streamed row equals the direct embedding of its tile."""
    jex, pex = extractors
    path = slides[1][0]
    cfg, jcfg = _cfgs()
    got = stream_embed.embed_slide_streaming(path, pex, (0,), cfg, BATCH)
    want = jstream.embed_slide_streaming(path, jex, (0,), jcfg, BATCH)
    _assert_same_result(got, want)
    feats, pos, stats = got
    assert stats.tiles_total == 16 and stats.tiles_kept % BATCH != 0
    assert stats.fetch_seconds > 0 and stats.filter_seconds > 0
    assert stats.resize_seconds == 0  # 512 is a multiple of the tile
    slide = open_slide(path)
    dz = DeepZoom(slide, TILE)
    (level, _), = magnification_plan(dz, (0,), 20, 20)
    tiles = np.stack([dz.get_tile(level, tuple(p)) for p in pos])
    slide.close()
    n = len(tiles)
    padded = np.concatenate([tiles, np.zeros((-n % BATCH, TILE, TILE, 3),
                                             np.uint8)])
    direct = np.concatenate([pex.embed_arrays(padded[i:i + BATCH])
                             for i in range(0, len(padded), BATCH)])[:n]
    np.testing.assert_allclose(feats, direct, **TOL)


def test_embed_slides_streaming_in_order(extractors, slides):
    """Several slides through one pipeline, in order, each as JAX's and as
    the one-slide path's (ragged edge tiles resized on slides 1 and 2);
    dropping the generator early stops the producer."""
    jex, pex = extractors
    cfg, jcfg = _cfgs()
    paths = slides[1]
    outs = list(stream_embed.embed_slides_streaming(paths, pex, (0,), cfg,
                                                    BATCH))
    wants = list(jstream.embed_slides_streaming(paths, jex, (0,), jcfg,
                                                BATCH))
    assert len(outs) == len(wants) == 3
    for got, want in zip(outs, wants):
        _assert_same_result(got, want)
    assert outs[1][2].resize_seconds > 0
    single = stream_embed.embed_slide_streaming(paths[2], pex, (0,), cfg,
                                                BATCH)
    np.testing.assert_array_equal(single[1], outs[2][1])
    np.testing.assert_allclose(single[0], outs[2][0], rtol=0, atol=1e-6)
    gen = stream_embed.embed_slides_streaming(paths, pex, (0,), cfg, BATCH)
    assert next(gen)[0].shape[0] > 0
    gen.close()


@pytest.mark.parametrize("shards", [None, 2])
def test_embed_dataset_streaming_matches_jax(tmp_path, extractors, slides,
                                             shards):
    jex, pex = extractors
    root = slides[0]
    cfg, jcfg = _cfgs()
    wsi = os.path.join(root, "WSI")
    for i in range(shards or 1):
        shard = (i, shards) if shards else None
        got = stream_embed.embed_dataset_streaming(
            wsi, "demo", pex, str(tmp_path / "port"), cfg, "tif",
            batch_size=BATCH, shard=shard, log=lambda s: None)
        assert (got is None) == bool(shards)
    if shards:
        feature_store.build_dataset_csvs(str(tmp_path / "port" / "demo"),
                                         "demo")
    jstream.embed_dataset_streaming(wsi, "demo", jex, str(tmp_path / "jax"),
                                    jcfg, "tif", batch_size=BATCH,
                                    log=lambda s: None)
    _assert_same_dataset(str(tmp_path / "port" / "demo"),
                         str(tmp_path / "jax" / "demo"), n_bags=3)


def _assert_same_dataset(got_root, want_root, n_bags):
    def bags(root):
        return sorted(os.path.relpath(p, root)
                      for p in glob.glob(os.path.join(root, "*", "*.csv")))

    assert bags(got_root) == bags(want_root)
    csvs = [p for p in bags(got_root) if not p.endswith(".pos.csv")]
    assert len(csvs) == n_bags
    for rel in csvs:
        a = feature_store.read_bag_csv(os.path.join(got_root, rel))
        b = feature_store.read_bag_csv(os.path.join(want_root, rel))
        assert a.shape == b.shape and np.abs(b).max() > 0.1
        np.testing.assert_allclose(a, b, rtol=0, atol=CSV_ATOL, err_msg=rel)
        pos = rel[:-4] + ".pos.csv"
        with open(os.path.join(got_root, pos)) as f, \
                open(os.path.join(want_root, pos)) as g:
            text = f.read()
            assert text == g.read() and text.startswith("col,row\n")
        assert text.count("\n") == a.shape[0] + 1

    def master(root):
        rows = feature_store.read_master_csv(
            os.path.join(root, os.path.basename(root) + ".csv"))
        return sorted((os.path.relpath(p, root), label) for p, label in rows)

    assert master(got_root) == master(want_root)
    assert len(master(got_root)) == n_bags


def test_stream_at_224_takes_the_k5_stem_route(tmp_path, weights):
    """224^2 tiles on a 2 x 2-tile tissue patch: every streamed batch goes
    through the stem kernel's wrapper (its plain version here), and the
    features equal JAX's."""
    (params, cfg_j), model = weights
    path = _slide(str(tmp_path), "t", "tumor", 5, size=448, tissue=448)
    cfg, jcfg = _cfgs(224)
    calls = []

    def counted(x, *args):
        calls.append(tuple(x.shape))
        return stem_ops.fused_stem(x, *args)

    pex = features.FeatureExtractor(model, 2, 224)
    resnet.fused_stem, orig = counted, resnet.fused_stem
    try:
        got = stream_embed.embed_slide_streaming(path, pex, (0,), cfg, 2)
    finally:
        resnet.fused_stem = orig
    jex = jfeatures.FeatureExtractor(params, cfg_j, 2, 224)
    want = jstream.embed_slide_streaming(path, jex, (0,), jcfg, 2)
    _assert_same_result(got, want)
    assert got[2].tiles_kept == 4
    assert calls == [(2, 224, 224, 3)] * 2


def _run_port_cli(args, cwd):
    out = subprocess.run([sys.executable, "-m", "tpumil_torch.cli.slide_feats",
                          *args], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_slide_feats_cli_matches_jax_cli(tmp_path, monkeypatch, weights,
                                         slides):
    """Both CLIs on one exported embedder and the same slides."""
    _, model = weights
    monkeypatch.chdir(tmp_path)
    torch.save(embedder.export_embedder_state_dict(model), "model.pth")
    common = ["--dataset", "demo", "--wsi_root",
              os.path.join(slides[0], "WSI"), "--slide_format", "tif",
              "--weights", "model.pth", "--tile_size", str(TILE),
              "--batch_size", str(BATCH), "--workers", "2",
              "--device", "cpu"]
    out = _run_port_cli(common + ["--out_root", "port"], str(tmp_path))
    assert "master CSV: port/demo/demo.csv" in out
    assert jax_cli.main(common + ["--out_root", "jax"]) == 0
    _assert_same_dataset("port/demo", "jax/demo", n_bags=3)


def test_cli_flags_device_and_unported_modes(monkeypatch):
    """The JAX CLI's flags and defaults, but for the device: the card,
    which raises without one; --data_parallel's refusals."""
    import argparse

    grabbed = {}

    def grab(self, *args, **kwargs):
        grabbed["parser"] = self
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(KeyboardInterrupt):
            jax_cli.main([])

    def flags(parser):
        return {a.dest: (a.default, tuple(a.option_strings), a.nargs, a.type,
                         a.required)
                for a in parser._actions}

    port, theirs = flags(cli.build_parser()), flags(grabbed["parser"])
    assert port.pop("device")[0] == "cuda"
    assert theirs.pop("device")[0] == "auto"
    assert port == theirs
    argv = ["--dataset", "demo"]
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(ValueError, match="must be >= 0, got -1"):
        cli.main(argv + ["--data_parallel", "-1", "--device", "cpu"])
    with pytest.raises(ValueError, match="batch_size 128 must divide by"):
        cli.main(argv + ["--data_parallel", "3", "--device", "cpu"])
    if not torch.cuda.is_available():
        for extra in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv + extra)
