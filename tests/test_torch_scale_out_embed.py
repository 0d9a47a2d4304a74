"""The embedding half of scale-out (tpumil_torch/parallel/mesh.py's
BatchShardedForward and follower loop; FeatureExtractor, BagInference,
InferenceService and SimCLRTrainer with a data-parallel mesh; the CLIs'
--data_parallel) against the JAX package's 2-device virtual CPU mesh
(tests/conftest.py forces 8 host devices) and the port's single-device
run, on the same seeded inputs.

The port runs in a spawned gloo world of 2 (tests/torch_parallel_util.py),
rank 0 feeding, rank 1 following. Bars: features, instance logits,
attention and scores within rtol/atol 1e-5 of the port's single-device run
(JAX's sharded-vs-unsharded bar, tests/test_features.py), and within the
port-vs-JAX bar of its single-device tests (1e-4: test_torch_heatmap.py)
of JAX's sharded run; served rows bitwise independent of request packing;
the SimCLR losses within rtol 1e-4 of JAX's sharded step
(tests/test_simclr.py's bar).

Patches are 64^2 (SimCLR fits 48^2): at 32^2 ResNet18's last stage is 1x1,
where instance norm gives 0 and every feature is 0, which compares nothing.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

import torch_parallel_util as tpu_util
from torch_parallel_util import BAG_BATCH, EMBED_BATCH, EMBED_PATCH
from torch_simclr_util import pair_uniforms
from tpumil.infer import features as jfeatures
from tpumil.infer import heatmap as jheat
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil.models.simclr import SimCLRConfig as JSimCLRConfig
from tpumil.ops.augment import pair_keys
from tpumil.parallel.mesh import make_mesh
from tpumil.train import simclr_trainer as jtrainer
from tpumil_torch.data import patches
from tpumil_torch.infer.features import FeatureExtractor
from tpumil_torch.infer.heatmap import BagInference
from tpumil_torch.infer.service import InferenceService
from tpumil_torch.io import from_jax
from tpumil_torch.models import embedder, simclr
from tpumil_torch.models.simclr import SimCLRConfig
from tpumil_torch.train.simclr_trainer import SimCLRTrainConfig, SimCLRTrainer
from tpumil_torch.utils import prof

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
AGGREGATOR = os.path.join(DATA, "tcga_aggregator.pth")
CPU = torch.device("cpu")
CFG32 = SimCLRConfig(compute_dtype=torch.float32)
SHARDED = dict(rtol=1e-5, atol=1e-5)   # sharded vs single-device, the port
PORT_JAX = dict(rtol=1e-4, atol=1e-4)  # the port vs JAX (their forwards)
# the SimCLR gradient, relative L2 distance per tensor: against JAX's,
# test_torch_simclr_trainer.py's bar (1.4e-2 here); against the port's
# single-device step, the same weights and views summed over two ranks in
# another order (2.0e-6 here)
GRAD_RL2_JAX, GRAD_RL2_PORT = 2e-2, 1e-4
# one epoch of two steps, the state saved after the first
RESUME_CFG = SimCLRTrainConfig(batch_size=4, epochs=1, input_size=48, lr=1e-3,
                               num_workers=2, log_every_n_steps=100,
                               save_every_n_steps=1)
# the resumed run's weights against the world's, relative L2 distance per
# tensor, over the world's update: the two sum the same gradients in
# another order (2.2e-6 here), and Adam turns a last-bit difference of a
# near-zero gradient element into up to 2 lr
UPDATE_RL2 = 1e-4


class _SGD:
    def init(self, params):
        return ()

    def step(self, params, opt_state, grads, lr):
        return jax.tree.map(lambda p, g: p - lr * g, params, grads), opt_state


def _jpegs(folder, n, size, seed, ext="jpg"):
    """``n`` seeded JPEG patches ``<a>_<b>.<ext>`` on a grid with holes."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    cells = [(a, b) for a in range(8) for b in range(8) if b % 3 != 1]
    out = []
    for i in rng.permutation(len(cells))[:n]:
        path = os.path.join(folder, "{}_{}.{}".format(*cells[i], ext))
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)) \
            .save(path)
        out.append(path)
    return sorted(out)


def _jax_simclr_step(images, key):
    """JAX's sharded SGD step over a 2-device mesh at batch 8, 64^2, f32:
    (weights before, loss, the gradient read off a step of lr 1)."""
    tr = jtrainer.SimCLRTrainer(
        JSimCLRConfig(compute_dtype=jnp.float32),
        jtrainer.SimCLRTrainConfig(batch_size=images.shape[0],
                                   input_size=EMBED_PATCH, lr=1e-3),
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)))
    tr.optimizer = _SGD()
    params = tr.init(jax.random.PRNGKey(0))[0]
    before = from_jax.simclr_state_dict(jax.tree.map(np.asarray, params),
                                        CFG32)
    x = jnp.asarray(images.astype(np.float32) / 255.0)
    unit, _, loss = tr._train_step(params, (), key, x,
                                   jnp.asarray(1.0, jnp.float32))
    after = from_jax.simclr_state_dict(jax.tree.map(np.asarray, unit), CFG32)
    return before, float(loss), {k: before[k].double() - after[k].double()
                                 for k in before}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (written here), JAX's sharded results on them, and the
    port's world of 2 run once over all of them."""
    tmp = tmp_path_factory.mktemp("embed_world")
    bag = str(tmp / "bags" / "slide13")
    paths = _jpegs(bag, 13, EMBED_PATCH, 0)
    images = np.stack([patches.decode_patch(p, EMBED_PATCH, as_float=False)
                       for p in paths])
    arrays = images[:5]
    # 12 paths: a valid split of 1 and two batches of 4 an epoch
    fit_paths = _jpegs(str(tmp / "fit"), 12, 48, 1, ext="jpeg")

    # the JAX embedder, seeded, its head the aggregator's instance head
    agg_params, _, model = jckpt.load_mil_pth(AGGREGATOR)
    c = int(np.asarray(agg_params["i_fc"]["w"]).shape[0])
    cfg_j = jemb.EmbedderConfig(num_classes=c, compute_dtype=jnp.float32,
                                precision="highest")
    params = jemb.init_params(jax.random.PRNGKey(0), cfg_j)
    backbone = from_jax.resnet_state_dict(params["backbone"],
                                          embedder.EmbedderConfig().resnet_cfg)
    emb_params = jemb.set_head(params, agg_params["i_fc"]["w"],
                               agg_params["i_fc"]["b"])
    jmesh = make_mesh(2, inst_parallel=1)
    jex = jfeatures.FeatureExtractor(emb_params, cfg_j, EMBED_BATCH,
                                     EMBED_PATCH, num_workers=2, mesh=jmesh)
    jbags = jheat.BagInference(emb_params, cfg_j, agg_params,
                               batch_size=BAG_BATCH, patch_size=EMBED_PATCH,
                               num_workers=2, model=model, mesh=jmesh)
    jax_out = {"paths": jex.embed_paths(paths),
               "arrays": jex.embed_arrays(arrays), "bag": jbags.run_bag(bag)}

    views = np.random.default_rng(4).integers(
        0, 256, (EMBED_BATCH, EMBED_PATCH, EMBED_PATCH, 3), np.uint8)
    key = jax.random.PRNGKey(11)
    before, loss, grad = _jax_simclr_step(views, key)
    uniforms = pair_uniforms(*pair_keys(key, EMBED_BATCH))

    inputs = str(tmp / "inputs.pt")
    torch.save({"aggregator": AGGREGATOR, "backbone": backbone,
                "paths": paths, "arrays": arrays, "bag": bag,
                "images": images, "simclr": before, "uniforms": uniforms,
                "views": views, "fit_paths": fit_paths,
                "resume_cfg": RESUME_CFG}, inputs)
    ranks = tpu_util.run_world(2, tpu_util.embed_world, inputs,
                               str(tmp / "run"), tmp=tmp / "spawn",
                               timeout=240.0)
    return {"tmp": tmp, "inputs": torch.load(inputs, weights_only=False),
            "jax": jax_out, "jax_step": (loss, grad), "port": ranks[0],
            "followers": ranks[1:]}


@pytest.fixture(scope="module")
def single_step(world):
    """The port's single-device SGD step on the world's SimCLR inputs:
    (loss, the gradient)."""
    inputs = world["inputs"]
    tr = SimCLRTrainer(CFG32, SimCLRTrainConfig(
        batch_size=EMBED_BATCH, input_size=EMBED_PATCH, lr=1e-3), device=CPU)
    model = simclr.SimCLR(CFG32, CPU)
    model.load_state_dict(inputs["simclr"])
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    loss = tr.train_step(model, opt, inputs["uniforms"],
                         torch.from_numpy(inputs["views"]), 1e-3)
    return float(loss), {k: p.grad.double()
                         for k, p in model.named_parameters()}


def test_refusals(world):
    """JAX's errors: a negative N, more devices than the group holds, and a
    batch (or SimCLR microbatch) that does not divide by the mesh."""
    r = world["port"]["refusals"]
    assert r["negative"] == "--data_parallel must be >= 0, got -1"
    assert r["too_many"] == ("requested 4 devices but only 2 are available "
                             "(a process group of 2)")
    for name in ("extractor", "bag_inference", "service"):
        assert "batch_size 7 must divide by the mesh's device count (2x1=2)" \
            == r[name], name
    assert "must be divisible by the data-parallel mesh size 2" \
        in r["simclr_batch"]
    assert r["simclr_microbatch"] == ("grad_cache_microbatch 3 must be "
                                      "divisible by the mesh size 2")


def test_feature_extractor_sharded(world):
    """embed_paths with a padded final batch (13 = 8 + 5) and embed_arrays
    of 5 rows (padded to 6) over the world of 2, against the port's
    single-device extractor and JAX's 2-device mesh."""
    emb, _, _ = tpu_util.embedder_of(world["inputs"])
    single = FeatureExtractor(emb, EMBED_BATCH, EMBED_PATCH, 2)
    got = world["port"]["embedded"]
    want = single.embed_paths(world["inputs"]["paths"])
    assert got["paths"].shape == want.shape == (13, 512)
    assert np.abs(want).max() > 1e-2  # a real comparison
    np.testing.assert_allclose(got["paths"], want, **SHARDED)
    np.testing.assert_allclose(got["paths"], world["jax"]["paths"],
                               **PORT_JAX)
    want = single.embed_arrays(world["inputs"]["arrays"])
    assert got["arrays"].shape == (5, 512)
    np.testing.assert_allclose(got["arrays"], want, **SHARDED)
    np.testing.assert_allclose(got["arrays"], world["jax"]["arrays"],
                               **PORT_JAX)
    # a header, a scatter and a gather per batch (2 + 1 + 4 batches), and
    # the "stop"
    assert world["port"]["feed_calls"] == 3 * 7 + 1


def test_bag_inference_sharded(world):
    emb, agg, model = tpu_util.embedder_of(world["inputs"])
    want = BagInference(emb, agg, batch_size=BAG_BATCH,
                        patch_size=EMBED_PATCH, num_workers=2,
                        model=model).run_bag(world["inputs"]["bag"])
    got = world["port"]["embedded"]["bag"]
    assert np.abs(want[2]).max() > 1e-3
    for g, w, j, what in zip(got, want, world["jax"]["bag"],
                             ("scores", "attention", "ins_logits")):
        assert g.shape == w.shape == j.shape, what
        np.testing.assert_allclose(g, w, **SHARDED, err_msg=what)
        np.testing.assert_allclose(g, j, **PORT_JAX, err_msg=what)
    np.testing.assert_array_equal(got[3], want[3])


def test_service_sharded(world):
    """Rows bitwise independent of request packing within the sharded
    service (tests/test_service.py's mesh case), and within float
    tolerance of the single-device service and of JAX's sharded
    features."""
    whole, repacked = world["port"]["served"]
    np.testing.assert_array_equal(repacked, whole)
    emb, _, _ = tpu_util.embedder_of(world["inputs"])
    svc = InferenceService(emb, CPU, batch_size=EMBED_BATCH,
                           patch_size=EMBED_PATCH, max_wait_ms=5.0)
    try:
        want = svc.embed(world["inputs"]["images"])
    finally:
        svc.close()
    assert whole.shape == (13, 512)
    np.testing.assert_allclose(whole, want, **SHARDED)
    np.testing.assert_allclose(whole, world["jax"]["paths"], **PORT_JAX)


@pytest.mark.parametrize("mb", [None, 4])
def test_simclr_sharded_step(world, single_step, mb):
    """One monolithic and one grad-cache SGD step over the world of 2: the
    loss within rtol 1e-4 of JAX's sharded step, the gradient within the
    port-vs-JAX bar of JAX's and near the port's single-device step's, the
    parameters equal on both ranks."""
    loss, grads, gap = world["port"]["steps"][mb]
    jax_loss, jax_grad = world["jax_step"]
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)
    assert gap == 0.0
    assert all(f["gaps"] == [0.0, 0.0] for f in world["followers"])
    single_loss, single_grad = single_step
    np.testing.assert_allclose(loss, single_loss, rtol=1e-5)
    assert grads.keys() == single_grad.keys()
    for k, g in grads.items():
        g, w, s = g.double(), jax_grad[k], single_grad[k]
        assert torch.isfinite(g).all() and g.abs().max() > 0, k
        assert ((g - w).norm() / w.norm()).item() <= GRAD_RL2_JAX, k
        assert ((g - s).norm() / s.norm()).item() <= GRAD_RL2_PORT, k


def test_simclr_fit_skipped_validation_and_resume(world, monkeypatch):
    """JAX's skipped-validation case (tests/test_simclr.py): a valid split
    of 1 under a mesh of 2 skips validation, still saves the resume state,
    and the same config resumes from it; then the state the world of 2
    saved after its first step resumes in one process and ends near the
    world's own run."""
    (first, again, _), state_saved, straight = world["port"]["fits"]
    assert any("validation skipped" in m for m in first)
    assert state_saved
    assert any(m.startswith("Resuming SimCLR pretraining at epoch 1")
               for m in again), again
    monkeypatch.setattr(prof, "_summary_writer", lambda logdir: None)
    run = world["tmp"] / "resumed"
    shutil.copytree(world["tmp"] / "run" / "snapshot", run / "state")
    lines = []
    trainer = SimCLRTrainer(CFG32, RESUME_CFG, device=CPU)
    out = trainer.fit(world["inputs"]["fit_paths"], str(run),
                      log=lines.append, resume=True)
    assert any(m.startswith("Resuming SimCLR pretraining at epoch 0 step 1")
               for m in lines), lines
    start = trainer.init(RESUME_CFG.seed)[0].state_dict()
    got = out["model"].state_dict()
    assert got.keys() == straight.keys()
    for k, v in straight.items():
        if not k.endswith(("weight", "bias")):
            continue
        want = v.double() - start[k].double()
        assert want.norm() > 0, k
        rl2 = ((got[k].double() - v.double()).norm() / want.norm()).item()
        assert rl2 <= UPDATE_RL2, (k, rl2)


def test_compute_feats_cli_data_parallel(tmp_path, monkeypatch):
    """``compute_feats --device cpu --data_parallel 2`` starts two gloo
    workers and writes the single-device run's CSVs (JAX's CLI bar, atol
    2e-4: %.4f text on features within 1e-5), the same dataset CSVs (up
    to the master's shuffle), and prints once."""
    from tpumil_torch.cli import compute_feats as cli
    from tpumil_torch.data import feature_store

    monkeypatch.chdir(tmp_path)
    for b, n in enumerate((9, 5)):
        _jpegs(str(tmp_path / "WSI" / "ds" / "single" / f"class{b}" /
                   f"bag{b}"), n, EMBED_PATCH, 10 + b, ext="jpeg")
    model = embedder.init_params(0, embedder.EmbedderConfig(num_classes=1),
                                 CPU)
    torch.save(embedder.export_embedder_state_dict(model), "model.pth")
    common = ["--dataset", "ds", "--weights", "model.pth", "--num_classes",
              "1", "--patch_size", str(EMBED_PATCH), "--batch_size", "4",
              "--num_workers", "2", "--device", "cpu"]
    out = tpu_util.run_cli("tpumil_torch.cli.compute_feats",
                           common + ["--out_root", "dp", "--data_parallel",
                                     "2"], str(tmp_path))
    assert "starting 2 workers on cpu" in out
    assert out.count("Throughput:") == 1 and "(14 patches)" in out
    assert cli.main(common + ["--out_root", "single"]) == 0
    for rel in ("class0/bag0.csv", "class1/bag1.csv"):
        a = feature_store.read_bag_csv(os.path.join("dp", "ds", rel))
        b = feature_store.read_bag_csv(os.path.join("single", "ds", rel))
        assert a.shape == b.shape and a.shape[1] == 512
        assert np.abs(b).max() > 0.1  # a real comparison
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=rel)
    for name in ("ds.csv", "class0.csv", "class1.csv"):  # the master shuffled
        with open(os.path.join("dp", "ds", name)) as f, \
                open(os.path.join("single", "ds", name)) as g:
            assert sorted(f.read().replace("dp/", "single/").splitlines()) \
                == sorted(g.read().splitlines()), name
