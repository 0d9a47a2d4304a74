"""The compute_feats slice against the JAX package: patch IO and batching,
per-bag feature CSVs (single and tree magnification), the dataset CSVs and
the CLI, on JPEG patch trees written with PIL and the same embedder weights
on both sides (carried over by tpumil_torch/io/from_jax.py).

Patches are 64^2: at 32^2 ResNet18's last stage is 1x1, where instance norm
outputs exactly 0 and every feature is 0 on both sides, which would compare
nothing.
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

from tpumil.cli import compute_feats as jax_cli
from tpumil.data import feature_store as jstore
from tpumil.data import patches as jpatches
from tpumil.infer import features as jfeatures
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil_torch.cli import compute_feats as cli
from tpumil_torch.data import feature_store, patches
from tpumil_torch.infer import features
from tpumil_torch.io import from_jax
from tpumil_torch.models import embedder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PATCH = 64
# features agree to 1e-4 (test_in_pallas.py's forward bar); the CSVs keep
# %.4f, so one last-digit flip on top
CSV_ATOL = 1.5e-4


def _write_patch(path, rng, size=PATCH):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(path)


def _single_tree(root, rng, n_bags=3, n_patches=6):
    for b in range(n_bags):
        for p in range(n_patches):
            _write_patch(os.path.join(root, "ds", "single", f"class{b % 2}",
                                      f"bag{b}", f"{p}_{p + 1}.jpeg"), rng)
    return root


def _pyramid_tree(root, rng):
    for li in range(2):
        _write_patch(os.path.join(root, "ds", "pyramid", "c0", "bag0",
                                  f"{li}_0.jpeg"), rng)
        for hi in range(3):
            _write_patch(os.path.join(root, "ds", "pyramid", "c0", "bag0",
                                      f"{li}_0", f"{2 * li + hi}_{hi}.jpeg"),
                         rng)
    return root


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


def _extractors(weights):
    (params, cfg_j), model = weights
    return (jfeatures.FeatureExtractor(params, cfg_j, batch_size=4,
                                       patch_size=PATCH, num_workers=2),
            features.FeatureExtractor(model, batch_size=4, patch_size=PATCH,
                                      num_workers=2))


def _assert_same_csvs(got_root, want_root, width):
    got = sorted(os.path.relpath(p, got_root)
                 for p in glob.glob(os.path.join(got_root, "*", "*.csv")))
    want = sorted(os.path.relpath(p, want_root)
                  for p in glob.glob(os.path.join(want_root, "*", "*.csv")))
    assert got == want and got
    for rel in got:
        a = feature_store.read_bag_csv(os.path.join(got_root, rel))
        b = feature_store.read_bag_csv(os.path.join(want_root, rel))
        assert a.shape == b.shape and a.shape[1] == width
        assert np.abs(b).max() > 0.1  # a real comparison
        np.testing.assert_allclose(a, b, rtol=0, atol=CSV_ATOL, err_msg=rel)


def test_patch_io_matches_jax(tmp_path):
    root = _single_tree(str(tmp_path / "WSI"), np.random.default_rng(0))
    dirs = patches.list_bag_dirs(root, "ds", "single")
    assert dirs == jpatches.list_bag_dirs(root, "ds", "single")
    assert len(dirs) == 3
    paths = patches.list_patches(dirs[0])
    assert paths == jpatches.list_patches(dirs[0]) and len(paths) == 6
    assert patches.parse_position(paths[1]) == (1, 2)
    for as_float in (True, False):
        got = patches.decode_patch(paths[0], 48, as_float)
        np.testing.assert_array_equal(got,
                                      jpatches.decode_patch(paths[0], 48,
                                                            as_float))


@pytest.mark.parametrize("patch_size", [None, 48])
def test_batch_loader_padding(tmp_path, patch_size):
    """uint8 batches as the JAX loader's, as decoded or resized."""
    root = _single_tree(str(tmp_path / "WSI"), np.random.default_rng(1),
                        n_bags=1, n_patches=7)
    paths = jpatches.list_patches(jpatches.list_bag_dirs(root, "ds",
                                                         "single")[0])
    got = list(patches.PatchBatchLoader(paths, batch_size=4,
                                        patch_size=patch_size, num_workers=2))
    want = list(jpatches.PatchBatchLoader(paths, batch_size=4,
                                          patch_size=patch_size,
                                          num_workers=2, out_dtype=np.uint8))
    assert [n for _, n, _ in got] == [4, 3]
    assert got[0][0].shape == (4, patch_size or PATCH, patch_size or PATCH, 3)
    assert got[0][0].dtype == np.uint8
    assert np.all(got[1][0][3:] == 0)  # the padded tail row is zero
    for (a, na, pa), (b, nb, pb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert na == nb and pa == pb


def test_compute_feats_matches_jax(tmp_path, weights):
    root = _single_tree(str(tmp_path / "WSI"), np.random.default_rng(2))
    dirs = patches.list_bag_dirs(root, "ds", "single")
    jex, pex = _extractors(weights)
    jfeatures.compute_feats(dirs, jex, str(tmp_path / "jax"))
    features.compute_feats(dirs, pex, str(tmp_path / "port"))
    _assert_same_csvs(str(tmp_path / "port"), str(tmp_path / "jax"), 512)
    assert pex.stats.patches == 18 and pex.stats.patches_per_sec > 0
    # a data-parallel mesh of one rank: the same batches through the
    # sharded forward, bitwise the single-device CSVs
    from tpumil_torch.parallel import mesh

    with mesh.data_parallel(1, "extraction", "cpu") as m:
        sharded = features.FeatureExtractor(weights[1], pex.batch_size,
                                            pex.patch_size, 2, mesh=m)
        features.compute_feats(dirs, sharded, str(tmp_path / "world1"))
    for path in glob.glob(str(tmp_path / "port" / "*" / "*.csv")):
        with open(path) as f, open(path.replace(
                os.sep + "port" + os.sep, os.sep + "world1" + os.sep)) as g:
            assert f.read() == g.read(), path


@pytest.mark.parametrize("fusion,width", [("cat", 1024), ("fusion", 512)])
def test_tree_feats_match_jax(tmp_path, weights, fusion, width):
    root = _pyramid_tree(str(tmp_path / "WSI"), np.random.default_rng(3))
    dirs = patches.list_bag_dirs(root, "ds", "tree")
    jex, pex = _extractors(weights)
    jfeatures.compute_tree_feats(dirs, jex, jex, str(tmp_path / "jax"), fusion)
    features.compute_tree_feats(dirs, pex, pex, str(tmp_path / "port"), fusion)
    _assert_same_csvs(str(tmp_path / "port"), str(tmp_path / "jax"), width)
    assert feature_store.read_bag_csv(glob.glob(str(
        tmp_path / "port" / "*" / "*.csv"))[0]).shape[0] == 6
    with pytest.raises(NotImplementedError):
        features.compute_tree_feats(dirs, pex, pex, str(tmp_path / "x"),
                                    "bogus")


def test_build_dataset_csvs_matches_jax(tmp_path):
    root = tmp_path / "feats"
    rng = np.random.default_rng(4)
    for cls, n in (("normal", 3), ("tumor", 4)):
        for b in range(n):
            feature_store.write_bag_csv(
                rng.standard_normal((5, 8)).astype(np.float32),
                str(root / cls / f"slide{b}.csv"))
    feature_store.write_bag_csv(np.zeros((5, 2), np.float32),
                                str(root / "tumor" / "slide0.pos.csv"))
    outs = []
    for name, fn in (("port", feature_store.build_dataset_csvs),
                     ("jax", jstore.build_dataset_csvs)):
        out = tmp_path / name
        out.mkdir()
        master = fn(str(root), "ds", out_dir=str(out),
                    rng=np.random.default_rng(7))
        assert master == str(out / "ds.csv")
        outs.append({f: (out / f).read_text()
                     for f in ("ds.csv", "normal.csv", "tumor.csv")})
    assert outs[0] == outs[1]
    rows = feature_store.read_master_csv(str(tmp_path / "port" / "ds.csv"))
    assert sorted(label for _, label in rows) == [0] * 3 + [1] * 4
    assert not any(p.endswith(".pos.csv") for p, _ in rows)


def _run_port_cli(args, cwd):
    out = subprocess.run([sys.executable, "-m", "tpumil_torch.cli.compute_feats",
                          *args], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_compute_feats_cli_matches_jax_cli(tmp_path, monkeypatch, weights):
    """The slice end to end: both CLIs on one exported embedder, then the
    port's shards and --assemble_only; the port's exported embedder.pth
    loads into the JAX package."""
    (params, cfg_j), model = weights
    monkeypatch.chdir(tmp_path)
    _single_tree("WSI", np.random.default_rng(5))
    torch.save(embedder.export_embedder_state_dict(model), "model.pth")
    common = ["--dataset", "ds", "--weights", "model.pth", "--num_classes",
              "1", "--patch_size", str(PATCH), "--batch_size", "4",
              "--num_workers", "2", "--device", "cpu"]
    out = _run_port_cli(common + ["--out_root", "port"], str(tmp_path))
    assert "Throughput:" in out and "(18 patches)" in out
    assert jax_cli.main(common + ["--out_root", "jax"]) == 0
    _assert_same_csvs("port/ds", "jax/ds", 512)
    assert len(feature_store.read_master_csv("port/ds/ds.csv")) == 3
    exported = jemb.load_simclr_checkpoint("embedder/ds/embedder.pth", cfg_j)
    for k, v in params["backbone"].items():
        np.testing.assert_array_equal(np.asarray(exported["backbone"][k]),
                                      np.asarray(v))

    shard = common + ["--out_root", "shards"]
    assert cli.main(shard + ["--shard", "0/2"]) == 0
    assert len(glob.glob("shards/ds/*/*.csv")) == 2  # bags 0 and 2
    assert not os.path.exists("shards/ds/ds.csv")  # no master yet
    assert cli.main(shard + ["--shard", "1/2"]) == 0
    assert cli.main(["--dataset", "ds", "--out_root", "shards",
                     "--assemble_only", "--device", "cpu"]) == 0
    assert len(feature_store.read_master_csv("shards/ds/ds.csv")) == 3
    _assert_same_csvs("shards/ds", "port/ds", 512)
    with pytest.raises(ValueError, match="i/n"):
        cli.main(shard + ["--shard", "bogus"])


def test_cli_unported_modes_and_the_card_raise(tmp_path, monkeypatch):
    """--data_parallel's refusals (JAX's messages) and the card's, before
    any worker starts or file is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="must be >= 0, got -1"):
        cli.main(["--data_parallel", "-1", "--device", "cpu"])
    with pytest.raises(ValueError, match="batch_size 128 must divide by"):
        cli.main(["--data_parallel", "3", "--device", "cpu"])
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="batch normalization"):
        cli.main(["--weights", "ImageNet", "--device", "cpu"])
    assert cli.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        for argv in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv)


def test_cli_flags_match_jax():
    """The JAX CLI's flags and defaults, but for the device: the card."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions}

    port, jax_flags = flags(cli.build_parser()), flags(jax_cli.build_parser())
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags
