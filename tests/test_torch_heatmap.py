"""The inference slice's library against the JAX package: BagInference over a
patch folder, run_attention_maps over a folder of bags, and the renders,
PNG and CSV writers (tpumil_torch/infer/heatmap.py against
tpumil/infer/heatmap.py), on the same seeded JPEG patches and the same
weights on both sides (the embedder carried over by
tpumil_torch/io/from_jax.py, the aggregators shipped as .pth or drawn from
one seed and carried over by from_jax.mil_state_dict).

Patches are 64^2: at 32^2 ResNet18's last stage is 1x1, where instance norm
outputs exactly 0 and every feature is 0 on both sides. A bag of 13 patches
at batch 4 leaves the last batch ragged, and the JAX package pads the bag
to its bucket of 16 under a mask where the port aggregates the 13 rows
unpadded.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpumil.infer import heatmap as jheat
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.models.registry import get_model as jget_model
from tpumil_torch.infer import heatmap
from tpumil_torch.io import from_jax, torch_ckpt
from tpumil_torch.models import embedder
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.registry import get_model

# the EmbedderConfig proxy that routes every JAX InstanceNorm through the
# Pallas kernel (interpret mode on the CPU)
from test_torch_slice import _FusedEmbCfg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")
PATCH = 64
BATCH = 4
# features agree to 1e-4 after ~20 normalizations (test_in_pallas.py:54);
# instance logits, attention and scores are smooth functions of them
TOL = dict(rtol=1e-4, atol=1e-4)


def _write_bag(bag_dir, n, seed):
    """``n`` JPEG patches at grid positions with holes (every third column
    skipped), ``<a>_<b>.jpg``."""
    rng = np.random.default_rng(seed)
    os.makedirs(bag_dir, exist_ok=True)
    cells = [(a, b) for a in range(8) for b in range(8) if b % 3 != 1]
    for i in rng.permutation(len(cells))[:n]:
        a, b = cells[i]
        Image.fromarray(rng.integers(0, 256, (PATCH, PATCH, 3), np.uint8)) \
            .save(os.path.join(bag_dir, f"{a}_{b}.jpg"))
    return bag_dir


def _aggregators(name):
    """(JAX params, port module, model name) of one aggregator."""
    if name in ("tcga", "c16"):
        path = os.path.join(DATA, f"{name}_aggregator.pth")
        params, _, model = jckpt.load_mil_pth(path)
        agg, _, port_model = torch_ckpt.load_mil_pth(path, CPU)
        assert port_model == model
        return params, agg, model
    params = jax.tree.map(np.asarray, jget_model(name).init_params(
        jax.random.PRNGKey(1), JCfg(feats_size=512, num_classes=2)))
    agg = get_model(name)(DSMILConfig(512, 2), CPU)
    agg.load_state_dict(from_jax.mil_state_dict(params, name), strict=True)
    return params, agg.eval(), name


@pytest.fixture(scope="module")
def backbone():
    """The JAX embedder's backbone, seeded, in both packages (heads zero)."""
    cfg_j = jemb.EmbedderConfig(num_classes=1, compute_dtype=jnp.float32,
                                precision="highest")
    params = jemb.init_params(jax.random.PRNGKey(0), cfg_j)
    sd = from_jax.resnet_state_dict(
        params["backbone"], embedder.EmbedderConfig().resnet_cfg)
    return params, sd


def _pair(backbone, name, fused=False):
    """(JAX BagInference, port BagInference) over the same weights, the
    embedder head set from the aggregator's instance classifier."""
    params, sd = backbone
    agg_params, agg, model = _aggregators(name)
    c = int(np.asarray(agg_params["i_fc"]["w"]).shape[0])
    cfg_j = jemb.EmbedderConfig(num_classes=c, compute_dtype=jnp.float32,
                                precision="highest")
    emb_params = jemb.set_head(params, agg_params["i_fc"]["w"],
                               agg_params["i_fc"]["b"])
    jax_inf = jheat.BagInference(
        emb_params, _FusedEmbCfg(cfg_j) if fused else cfg_j, agg_params,
        batch_size=BATCH, patch_size=PATCH, num_workers=2, model=model)
    emb = embedder.Embedder(embedder.EmbedderConfig(num_classes=c), CPU)
    emb.feature_extractor.load_state_dict(sd, strict=True)
    fc = agg.i_classifier.fc
    fc = fc[0] if isinstance(fc, torch.nn.Sequential) else fc
    emb.set_head(fc.weight.detach(), fc.bias.detach())
    port_inf = heatmap.BagInference(emb, agg, batch_size=BATCH,
                                    patch_size=PATCH, num_workers=2,
                                    model=model)
    return jax_inf, port_inf


@pytest.fixture(scope="module")
def bag13(tmp_path_factory):
    return _write_bag(str(tmp_path_factory.mktemp("bag") / "slide13"), 13, 0)


BAG_CASES = ([(agg, avg, False) for agg in ("tcga", "c16")
              for avg in (False, True)]
             + [(agg, avg, False) for agg in ("abmil", "meanpool", "maxpool")
                for avg in (False, True)]
             + [("tcga", False, True)])


@pytest.mark.parametrize("agg,average,fused", BAG_CASES)
def test_run_bag_matches_jax(backbone, bag13, agg, average, fused):
    jax_inf, port_inf = _pair(backbone, agg, fused)
    want = jax_inf.run_bag(bag13, average=average)
    got = port_inf.run_bag(bag13, average=average)
    for g, w, what in zip(got, want, ("scores", "attention", "ins_logits",
                                      "positions")):
        assert g.shape == w.shape, what
    scores, attn, logits, pos = got
    assert np.abs(want[2]).max() > 1e-3  # a real comparison
    np.testing.assert_allclose(scores, want[0], **TOL)
    np.testing.assert_allclose(attn, want[1], **TOL)
    np.testing.assert_allclose(logits, want[2], **TOL)
    np.testing.assert_array_equal(pos, want[3])
    assert pos.shape == (13, 2) and attn.shape == (13, logits.shape[1])
    assert port_inf.stats.bags == 1 and port_inf.stats.patches == 13


@pytest.mark.parametrize("model", ["dsmil", "abmil", "meanpool", "maxpool"])
def test_unpadded_bag_equals_masked_bucket(model):
    """The port's aggregation without padding against the same aggregator
    over the bag zero-padded to its bucket of 16 under a mask (what the JAX
    package runs): the same scores and attention on the real rows, and
    exactly zero attention on the padding."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((13, 512)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((13, 2)).astype(np.float32))
    agg = get_model(model).init_params(torch.Generator().manual_seed(0),
                                       DSMILConfig(512, 2), CPU).eval()
    pad = lambda t: torch.cat([t, torch.zeros(3, t.shape[1])])  # noqa: E731
    mask = torch.arange(16) < 13
    with torch.inference_mode():
        _, bag, attn, _ = agg(feats, None, ins_logits=logits)
        _, bag_p, attn_p, _ = agg(pad(feats), mask, ins_logits=pad(logits))
    np.testing.assert_allclose(bag.numpy(), bag_p.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(attn.numpy(), attn_p[:13].numpy(), rtol=1e-6,
                               atol=1e-7)
    assert torch.all(attn_p[13:] == 0)


@pytest.fixture(scope="module")
def two_bags(tmp_path_factory):
    root = tmp_path_factory.mktemp("bags")
    for i, n in enumerate((6, 9)):
        _write_bag(str(root / "patches" / f"slide{i}"), n, 10 + i)
    return sorted(glob.glob(str(root / "patches" / "*")))


@pytest.fixture(scope="module")
def tcga_pair(backbone):
    return _pair(backbone, "tcga")


def _decode(path):
    return np.asarray(Image.open(path), np.int32)


# both classes, class 0 only, benign: the verdicts do not hinge on a score
# near its threshold
@pytest.mark.parametrize("thresholds", [[0.0, 0.0], [0.0, 1.1], [1.1, 1.1]])
def test_run_attention_maps_matches_jax(tcga_pair, two_bags, tmp_path,
                                        monkeypatch, thresholds):
    jax_inf, port_inf = tcga_pair
    drawn = {}

    def spy(mod, key):
        real = mod.render_color_map

        def render(attention, positions, detected, colors, upscale=32):
            drawn.setdefault(key, [np.asarray(c) for c in colors])
            return real(attention, positions, detected, colors, upscale)
        monkeypatch.setattr(mod, "render_color_map", render)

    logs, results = {}, {}
    for key, mod, infer in (("jax", jheat, jax_inf),
                            ("port", heatmap, port_inf)):
        spy(mod, key)
        logs[key] = []
        results[key] = mod.run_attention_maps(
            infer, two_bags, thresholds, ["LUAD", "LUSC"],
            str(tmp_path / key / "maps"),
            score_path=str(tmp_path / key / "scores"), seed=0,
            keep_maps=True, log=logs[key].append)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2
    for a, b in zip(drawn["port"], drawn["jax"]):
        np.testing.assert_array_equal(a, b)
    exact = []
    for got, want in zip(results["port"], results["jax"]):
        assert got.name == want.name and got.detected == want.detected
        np.testing.assert_allclose(got.scores, want.scores, **TOL)
        np.testing.assert_allclose(got.attention, want.attention, **TOL)
        png = _decode(tmp_path / "port" / "maps" / f"{got.name}.png")
        ref = _decode(tmp_path / "jax" / "maps" / f"{got.name}.png")
        assert png.shape == ref.shape == got.color_map.shape
        assert np.abs(png - ref).max() <= 1
        exact.append(float(np.mean(png == ref)))
        if not got.detected:
            assert np.all(png == 0) and np.all(got.color_map == 0)
        else:
            assert png.max() > 0
        a = np.loadtxt(tmp_path / "port" / "scores" / f"{got.name}.csv",
                       delimiter=",", skiprows=1, usecols=(0, 1))
        b = np.loadtxt(tmp_path / "jax" / "scores" / f"{got.name}.csv",
                       delimiter=",", skiprows=1, usecols=(0, 1))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    print(f"PNG values exactly equal: {exact}")


def test_keep_maps_and_missing_bag(tcga_pair, two_bags, tmp_path):
    _, port_inf = tcga_pair
    (res,) = heatmap.run_attention_maps(
        port_inf, two_bags[:1], [0.0, 0.0], ["a", "b"], str(tmp_path),
        seed=1, log=lambda s: None)
    assert res.color_map is None and res.detected == [0, 1]
    empty = tmp_path / "empty"
    empty.mkdir()
    for infer in tcga_pair:
        with pytest.raises(FileNotFoundError, match="no \\*.jpg patches"):
            infer.run_bag(str(empty))


def test_bag_inference_refusals():
    """A mesh of more devices than the process group holds is refused
    (JAX's take_devices), one of one rank is taken; a wrong model too."""
    from tpumil_torch.parallel import mesh

    emb = embedder.Embedder(embedder.EmbedderConfig(num_classes=2), CPU)
    agg = get_model("dsmil")(DSMILConfig(512, 2), CPU)
    with mesh.data_parallel(1, "embedding", "cpu") as m:
        assert heatmap.BagInference(emb, agg, mesh=m).extractor._sharded \
            .n_shard == 1
        with pytest.raises(ValueError, match="requested 2 devices but only "
                                             "1 are available"):
            mesh.data_parallel_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="not a 'abmil' model"):
        heatmap.BagInference(emb, agg, model="abmil")


def _attention_positions(seed, n, c, dtype):
    rng = np.random.default_rng(seed)
    attn = (rng.random((n, c)) * 0.3 + 0.01).astype(dtype)
    attn[0, 0] = 1e-5
    attn[-1, -1] = 1.5e-8
    positions = np.stack([rng.integers(0, 120, n), rng.integers(0, 9, n)], 1)
    return attn, positions


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 2), (2, 3)])
def test_renders_match_jax_exactly(seed, c, tmp_path):
    attn, positions = _attention_positions(seed, 11, c, np.float32)
    colors = [np.random.default_rng(seed).integers(0, 256, size=3)
              for _ in range(c)]
    for detected in ([], [0], list(range(c))):
        np.testing.assert_array_equal(
            heatmap.render_color_map(attn, positions, detected, colors, 4),
            jheat.render_color_map(attn, positions, detected, colors, 4))
    for color in (np.asarray([0.0, 1.0, 0.0]), np.zeros(3)):
        for k in range(c):
            got = heatmap.render_single_class_map(attn[:, k], positions,
                                                  color, 2)
            want = jheat.render_single_class_map(attn[:, k], positions,
                                                 color, 2)
            np.testing.assert_array_equal(got, want)
    image = heatmap.render_color_map(attn, positions, [0], colors, 2)
    heatmap.save_png(image, str(tmp_path / "port" / "m.png"))
    jheat.save_png(image, str(tmp_path / "jax" / "m.png"))
    np.testing.assert_array_equal(_decode(tmp_path / "port" / "m.png"),
                                  _decode(tmp_path / "jax" / "m.png"))


@pytest.mark.parametrize("seed,c,dtype", [(0, 1, np.float32),
                                          (1, 2, np.float32),
                                          (2, 3, np.float32),
                                          (3, 2, np.float64)])
def test_scores_csv_bytes_equal_pandas(seed, c, dtype, tmp_path):
    attn, positions = _attention_positions(seed, 17, c, dtype)
    heatmap.export_scores_csv(attn, positions, str(tmp_path / "p" / "s.csv"))
    jheat.export_scores_csv(attn, positions, str(tmp_path / "j" / "s.csv"))
    got = (tmp_path / "p" / "s.csv").read_bytes()
    assert got == (tmp_path / "j" / "s.csv").read_bytes()
    assert got.startswith(",".join([*map(str, range(c)), "pos"]).encode())
