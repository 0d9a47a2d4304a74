"""The port's other registry aggregators (tpumil_torch/models/{abmil,poolmil,
milnet}.py), their checkpoints and the trainer, schemes and server with
them, against the JAX package's on the same numpy weights; and the kernel
route (tpumil_torch/ops/attention_pool.py) at a feature width that is not a
multiple of 4, against the JAX package's Pallas route in interpret mode.

Bars: forwards 1e-5; one Adam step and the kernel route's epoch as
test_torch_trainer.py (losses rtol 2e-4, parameters rtol 1e-3 / atol
2e-5); the pooled loss and its gradients as test_torch_attention_pool.py
(loss rtol 1e-4, gradients rtol 5e-3 / atol 1e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.data import mil_bench as jmb
from tpumil.data.device_store import DeviceBagStore as JStore
from tpumil.io import torch_ckpt as jckpt
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.models.milnet import MILNet as JMILNet
from tpumil.models.registry import get_model as jget_model
from tpumil.ops import dsmil_pallas as jpool
from tpumil.train import optim as joptim
from tpumil.train import schemes as jschemes
from tpumil.train import trainer as jtrainer
from tpumil_torch.cli.attention_map import load_milnet
from tpumil_torch.data import mil_bench
from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.infer.service import InferenceService
from tpumil_torch.io import from_jax, torch_ckpt
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.milnet import MILNet
from tpumil_torch.models.registry import get_model
from tpumil_torch.ops import attention_pool as ap
from tpumil_torch.train import schemes
from tpumil_torch.train.trainer import BagTrainer

from synth import make_separable_bags

CPU = torch.device("cpu")
MUSK = os.path.join(os.path.dirname(__file__), "data", "musk1_mini.svm")
K, C = 20, 2
OTHERS = ["abmil", "meanpool", "maxpool"]


def _jax_params(model, k=K, c=C, seed=0):
    return jax.tree.map(np.asarray, jget_model(model).init_params(
        jax.random.PRNGKey(seed), JCfg(feats_size=k, num_classes=c)))


def _port(model, params, k=K, c=C):
    net = get_model(model)(DSMILConfig(k, c), CPU)
    net.load_state_dict(from_jax.mil_state_dict(params, model), strict=True)
    return net


def _assert_params_close(params, net, model, skip=()):
    got = from_jax.mil_params(net.state_dict(), model)
    for (path, want), x in zip(jax.tree.leaves_with_path(params),
                               jax.tree.leaves(got)):
        if jax.tree_util.keystr(path) in skip:
            continue
        np.testing.assert_allclose(x, np.asarray(want), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _batch(seed=0):
    """Two bags of 7 rows, the second padded after 5; instance logits with
    ties at the maximum (column 0: rows 1, 3, 5; column 1: every row)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 7, K)).astype(np.float32)
    mask = np.ones((2, 7), bool)
    mask[1, 5:] = False
    ties = np.stack([[1, 3, 0, 3, 2, 3, -1], [2] * 7], axis=1)
    logits = np.stack([ties, ties[::-1]]).astype(np.float32)
    return feats, mask, logits


# DSMIL's untied forward is test_torch_dsmil.py's
FORWARD_CASES = [(m, t, k) for m in OTHERS for t in (False, True)
                 for k in (False, True)] + [("dsmil", True, False),
                                            ("dsmil", True, True)]


@pytest.mark.parametrize("model,tied,masked", FORWARD_CASES)
def test_forward_matches_jax(model, tied, masked):
    """(c, bag_logits, A, B) within 1e-5 of the JAX model, batched and per
    bag. ``tied`` passes instance logits with tied maxima: maxpool's one-hot
    and DSMIL's critical instance take the first maximum, as jnp.argmax."""
    params = _jax_params(model)
    net = _port(model, params)
    feats, mask, logits = _batch()
    m = mask if masked else None
    lg = logits if tied else None
    want = jget_model(model).forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(feats),
        None if m is None else jnp.asarray(m),
        ins_logits=None if lg is None else jnp.asarray(lg))
    with torch.no_grad():
        got = net(torch.from_numpy(feats),
                  None if m is None else torch.from_numpy(m),
                  ins_logits=None if lg is None else torch.from_numpy(lg))
        single = net(torch.from_numpy(feats[0]))
    for name, g, w in zip(("c", "bag_logits", "A", "B"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if not (tied or masked):
        for g, w in zip(single, got):
            np.testing.assert_allclose(g.numpy(), w[0].numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("model", OTHERS)
def test_adam_steps_match_jax(model):
    """One epoch of per-bag Adam steps through both BagTrainers from the
    same weights: losses, parameters and scores. The pooling buffer is no
    parameter: Adam leaves it as it was."""
    rng = np.random.default_rng(1)
    jbags = make_separable_bags(rng, num_bags=4, feats=K, signal=3.0,
                                mean_instances=10)
    pbags = [Bag(b.feats, b.label, b.name) for b in jbags]
    params = _jax_params(model, c=1, seed=2)
    jt = jtrainer.BagTrainer(JCfg(K, 1), model=model, optimizer=joptim.adam_torch(
        betas=(0.5, 0.9), weight_decay=1e-3))
    pt = BagTrainer(DSMILConfig(K, 1), model=model, weight_decay=1e-3,
                    device=CPU)
    net = _port(model, params, c=1)
    opt = pt.make_optimizer(net)
    assert "pooling.mode" not in dict(net.named_parameters())
    mode = {k: v.clone() for k, v in net.named_buffers()}
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, want = jt.train_epoch(jp, jt.optimizer.init(jp), jbags, 1e-3,
                                  np.random.default_rng(3))
    net, opt, got = pt.train_epoch(net, opt, pbags, 1e-3,
                                   np.random.default_rng(3))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    jp = jax.tree.map(np.asarray, jp)
    # softmax_N(gate + b) does not depend on the gate's bias b: its exact
    # gradient is 0, and Adam's normalised step turns the rounding of the
    # computed one into up to ~1.9 lr per step, of either sign, on either
    # side. So b is held to that bound, not to the other package's value.
    skip = ("['att_w']['b']",) if model == "abmil" else ()
    if skip:
        bound = 2 * len(pbags) * 1e-3
        assert abs(float(jp["att_w"]["b"][0])) <= bound
        assert abs(float(net.b_classifier.attention_w.bias)) <= bound
    _assert_params_close(jp, net, model, skip)
    for k, v in net.named_buffers():
        assert torch.equal(v, mode[k]), k
    sj, _ = jt.predict(jp, jbags)
    sp, _ = pt.predict(net, pbags)
    np.testing.assert_allclose(sp, sj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", OTHERS + ["dsmil"])
def test_pth_round_trips_both_ways(tmp_path, model):
    """JAX save_mil_pth -> port load_mil_pth (strict), and port
    save_mil_pth -> JAX load_mil_pth, for each schema; a module saved under
    another schema's name is refused."""
    params = _jax_params(model)
    theirs, ours = str(tmp_path / "j.pth"), str(tmp_path / "p.pth")
    jckpt.save_mil_pth(params, theirs, model)
    net, cfg, name = torch_ckpt.load_mil_pth(theirs, CPU)
    assert name == model and (cfg.feats_size, cfg.num_classes) == (K, C)
    assert isinstance(net, get_model(model)) and not net.training
    for k, v in from_jax.mil_state_dict(params, model).items():
        assert torch.equal(net.state_dict()[k], v), k
    torch_ckpt.save_mil_pth(net, ours, model)
    back, _, jname = jckpt.load_mil_pth(ours)
    assert jname == model
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
    other = "meanpool" if model != "meanpool" else "abmil"
    with pytest.raises(ValueError, match="schema"):
        torch_ckpt.save_mil_pth(net, ours, other)


@pytest.mark.parametrize("average", [False, True])
def test_milnet_score_matches_jax(tmp_path, average):
    feats, mask, _ = _batch(4)
    params = _jax_params("dsmil", seed=5)
    jnet = JMILNet(jax.tree.map(jnp.asarray, params), JCfg(K, C))
    path = str(tmp_path / "a.pth")
    jnet.save_pth(path)
    net = MILNet.from_pth(path, CPU)
    np.testing.assert_allclose(net.score(feats, mask, average=average),
                               jnet.score(feats, mask, average=average),
                               rtol=1e-5, atol=1e-6)
    net.save_pth(str(tmp_path / "b.pth"))
    np.testing.assert_allclose(
        JMILNet.from_pth(str(tmp_path / "b.pth")).score(feats[0]),
        net.score(feats[0]), rtol=1e-5, atol=1e-6)
    ab = MILNet.create(K, C, model="abmil", device=CPU)
    assert ab.score(feats, mask).shape == (2, C)
    with pytest.raises(ValueError, match="dsmil"):
        ab.save_pth(str(tmp_path / "c.pth"))
    torch_ckpt.save_mil_pth(ab.module, str(tmp_path / "c.pth"), "abmil")
    with pytest.raises(ValueError, match="abmil"):
        MILNet.from_pth(str(tmp_path / "c.pth"), CPU)


def _jax_init(self, generator):
    """The JAX init of key ``generator.initial_seed()`` for the trainer's
    model, carried over through from_jax."""
    params = _jax_params(self.model, self.cfg.feats_size, self.cfg.num_classes,
                         generator.initial_seed())
    net = _port(self.model, params, self.cfg.feats_size, self.cfg.num_classes)
    return net, self.make_optimizer(net)


def test_run_5fold_cv_abmil_matches_jax(monkeypatch):
    """The 5-fold-cv WSI scheme with model="abmil", the port's init replaced
    by the JAX init of the same key: equal accuracies, AUCs within 1e-6."""
    rng = np.random.default_rng(0)
    jbags = make_separable_bags(rng, num_bags=15, feats=16, signal=6.0,
                                pos_inst_frac=0.5, mean_instances=12)
    pbags = [Bag(b.feats, b.label, b.name) for b in jbags]
    kw = dict(feats_size=16, num_classes=1, num_epochs=2, lr=1e-3,
              stop_epochs=2, verbose=False, seed=0, model="abmil")
    want = jschemes.run_5fold_cv(jbags, jschemes.WSITrainConfig(**kw),
                                 log=lambda s: None)
    monkeypatch.setattr(BagTrainer, "init", _jax_init)
    got = schemes.run_5fold_cv(pbags, schemes.WSITrainConfig(**kw, device=CPU),
                               log=lambda s: None)
    assert [f["acc"] for f in got["folds"]] == [f["acc"] for f in want["folds"]]
    np.testing.assert_allclose([f["aucs"] for f in got["folds"]],
                               [f["aucs"] for f in want["folds"]], atol=1e-6)
    assert got["mean_accuracy"] == want["mean_accuracy"]


def test_load_milnet_and_service_with_abmil(tmp_path, capsys):
    """An ABMIL .pth through load_milnet (the embedder's head comes from
    its i_classifier.fc) and the server's predict, against the JAX
    forward on the same weights."""
    params = _jax_params("abmil", k=512, c=2, seed=6)
    path = str(tmp_path / "abmil.pth")
    jckpt.save_mil_pth(params, path, "abmil")
    emb, _, agg, name = load_milnet("ImageNet", path, 2, CPU)
    assert name == "abmil" and "seeded random init" in capsys.readouterr().out
    np.testing.assert_array_equal(emb.fc.weight.detach().numpy(),
                                  params["i_fc"]["w"])
    svc = InferenceService(emb, CPU, aggregator=agg, model=name, batch_size=2,
                           patch_size=64)
    try:
        feats = np.random.default_rng(7).standard_normal((9, 512)).astype(
            np.float32)
        res = svc.predict(feats)
        _, bag, attn, _ = jget_model("abmil").forward(
            jax.tree.map(jnp.asarray, params), jnp.asarray(feats))
        np.testing.assert_allclose(res["scores"], np.asarray(jax.nn.sigmoid(bag)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["attention"], np.asarray(attn),
                                   rtol=1e-5, atol=1e-7)
        assert svc.health()["model"] == "abmil"
    finally:
        svc.close()


# -- the kernel route at K = 166 (musk) ----------------------------------------

def _musk_store():
    """musk1_mini's first bags as one flat [sum N, 166] tensor, and a bag
    whose view starts at an odd row, off a 16-byte boundary (664-byte
    rows)."""
    bags = mil_bench.parse_mil_file(MUSK, 166)[:6]
    store = DeviceBagStore(bags, device=CPU)
    odd = next(i for i in range(len(bags)) if store.offsets[i] % 2)
    return store, store.bag(odd)


def test_aligned_pads_only_when_needed():
    f = torch.zeros(5, 512)
    w0 = torch.zeros(128, 512)
    assert ap._aligned(f, w0) == (f, w0)  # the K = 512 path copies nothing
    _, view = _musk_store()
    assert view.data_ptr() % 16 != 0
    g, w = ap._aligned(view, torch.ones(128, 166))
    assert g.shape == (view.shape[0], 168) and w.shape == (128, 168)
    assert g.data_ptr() % 16 == 0
    assert torch.equal(g[:, :166], view) and not g[:, 166:].any()
    assert not w[:, 166:].any()


def test_fused_bag_loss_and_forward_at_k166_match_jax():
    """fused_bag_loss (loss and parameter gradients) and fused_bag_forward
    on a misaligned K = 166 bag view, against make_fused_bag_loss and
    fused_bag_forward in interpret mode."""
    _, feats = _musk_store()
    assert feats.data_ptr() % 16 != 0
    params = _jax_params("dsmil", k=166, c=1, seed=8)
    n = feats.shape[0]
    label = np.asarray([1.0], np.float32)
    pw = np.asarray([0.7], np.float32)
    padded = np.zeros((128, 166), np.float32)
    padded[:n] = feats.numpy()
    loss_fn = jpool.make_fused_bag_loss(
        jpool.make_trainable_pool(tile_n=128, interpret=True))
    want, grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(padded),
        jnp.asarray([n], jnp.int32), jnp.asarray(label), jnp.asarray(pw))
    net = _port("dsmil", params, 166, 1)
    loss = ap.fused_bag_loss(net, feats, torch.from_numpy(label),
                             torch.from_numpy(pw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    got = from_jax.dsmil_params({k: p.grad for k, p in net.named_parameters()})
    for (path, g), x in zip(jax.tree.leaves_with_path(grads),
                            jax.tree.leaves(got)):
        assert x.shape == np.asarray(g).shape
        np.testing.assert_allclose(x, np.asarray(g), rtol=5e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    bag, mx = jpool.fused_bag_forward(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(padded), n, tile_n=128,
                                      interpret=True)
    got_bag, got_max = ap.fused_bag_forward(net, feats)
    np.testing.assert_allclose(got_bag.numpy(), np.asarray(bag), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(mx), rtol=1e-5,
                               atol=1e-6)


def test_kernel_route_trains_musk_as_jax():
    """One epoch of BagTrainer(DSMILConfig(166, 1), fused_threshold=0) over
    a store of musk bags, against the JAX trainer's Pallas route on the
    same store: loss, parameters and every bucket through the pool."""
    store, _ = _musk_store()
    jbags = jmb.parse_mil_file(MUSK, 166)[:6]
    params = _jax_params("dsmil", k=166, c=1, seed=0)
    jt = jtrainer.BagTrainer(JCfg(166, 1), fused_threshold=0)
    pt = BagTrainer(DSMILConfig(166, 1), fused_threshold=0, device=CPU)
    net = _port("dsmil", params, 166, 1)
    opt = pt.make_optimizer(net)
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, want = jt.train_epoch(jp, jt.optimizer.init(jp), JStore(jbags),
                                 1e-3, np.random.default_rng(0))
    net, opt, got = pt.train_epoch(net, opt, store, 1e-3,
                                   np.random.default_rng(0))
    assert pt.fused_dispatches == len(store.bucket_sizes)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _assert_params_close(jax.tree.map(np.asarray, jp), net, "dsmil")
