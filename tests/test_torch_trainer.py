"""The port's BagTrainer (tpumil_torch/train/trainer.py) and optimizer
against the JAX package's, from the same parameters (carried over by
tpumil_torch/io/from_jax.py) and the same np.random seed, with dropout off.
Bars are test_trainer.py's fused-vs-XLA ones: per-epoch losses rtol 2e-4,
parameters rtol 1e-3 / atol 2e-5, scores rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.data.bags import Bag as JBag
from tpumil.data.device_store import DeviceBagStore as JStore
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.train import optim as joptim
from tpumil.train import trainer as jtrainer
from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.io import from_jax
from tpumil_torch.models import dsmil
from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
from tpumil_torch.ops.init import orthogonal_torch
from tpumil_torch.train import optim, trainer
from tpumil_torch.train.trainer import BagTrainer

CPU = torch.device("cpu")
K = 24


def test_adam_and_cosine_match_jax():
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(5)]
    lr_of = optim.cosine_annealing_lr(1e-2, 5, 5e-4)
    want_lr = joptim.cosine_annealing_lr(1e-2, 5, 5e-4)
    assert [lr_of(e) for e in range(5)] == [want_lr(e) for e in range(5)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optim.adam_torch([p], weight_decay=1e-3)
    jopt = joptim.adam_torch(betas=(0.5, 0.9), weight_decay=1e-3)
    params = {"w": jnp.asarray(w0)}
    state = jopt.init(params)
    for e, g in enumerate(grads):
        optim.set_lr(opt, lr_of(e))
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        params, state = jopt.step(params, state, {"w": jnp.asarray(g)},
                                  want_lr(e))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-5, atol=1e-6)


def _bags(seed, sizes, c=2):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = rng.standard_normal((n, K)).astype(np.float32)
        x[: max(1, n // 8)] += 2.0 * (i % 2)
        label = np.zeros(c, np.float32)
        label[i % c] = 1.0
        out.append((x, label, f"b{i}"))
    return ([JBag(x, y, n) for x, y, n in out], [Bag(x, y, n) for x, y, n in out])


def _pair(thr, c=2, **kw):
    """The two trainers, the JAX (params, opt_state) and the port's (model,
    optimizer) holding the same parameters."""
    jt = jtrainer.BagTrainer(JCfg(K, c), optimizer=joptim.adam_torch(
        betas=(0.5, 0.9), weight_decay=1e-3), fused_threshold=thr, **kw)
    pt = BagTrainer(DSMILConfig(K, c), weight_decay=1e-3, fused_threshold=thr,
                    device=CPU, **kw)
    params, opt_state = jt.init(jax.random.PRNGKey(0))
    model = DSMIL(DSMILConfig(K, c), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(
        jax.tree.map(np.asarray, params)))
    return jt, pt, (params, opt_state), (model, pt.make_optimizer(model))


def _assert_params_close(params, model):
    got = from_jax.dsmil_params(model.state_dict())
    for (path, want), x in zip(jax.tree.leaves_with_path(params),
                               jax.tree.leaves(got)):
        np.testing.assert_allclose(x, np.asarray(want), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


# sizes give buckets 16, 32, 64 and 128; fused_threshold=64 routes the two
# largest to the kernels' plain versions here (Pallas in interpret mode on
# the JAX side)
SIZES = [10, 30, 60, 45, 100, 14]


@pytest.mark.parametrize("path", ["list", "store", "store_epochs"])
@pytest.mark.parametrize("thr", [None, 64])
def test_trainer_matches_jax(path, thr):
    jbags, pbags = _bags(0, SIZES)
    if path == "store_epochs":  # one bucket: the single-dispatch epochs path
        jbags, pbags = _bags(1, [70, 90, 128, 100])
    jt, pt, (params, ostate), (model, opt) = _pair(thr, chunk_size=2)
    pw = np.asarray([1.3, 0.8], np.float32)
    jt.pos_weight = pt.pos_weight = pw
    jdata = jbags if path == "list" else JStore(jbags)
    pdata = pbags if path == "list" else DeviceBagStore(pbags, device=CPU)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    lrs = [1e-3, 5e-4]
    if path == "store_epochs":
        params, ostate, want = jt.train_epochs(params, ostate, jdata, lrs, r1)
        model, opt, got = pt.train_epochs(model, opt, pdata, lrs, r2)
    else:
        want, got = [], []
        for lr in lrs:
            params, ostate, lj = jt.train_epoch(params, ostate, jdata, lr, r1)
            model, opt, lp = pt.train_epoch(model, opt, pdata, lr, r2)
            want.append(lj)
            got.append(lp)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _assert_params_close(params, model)
    for average in (False, True):
        sj, lj = jt.predict(params, jdata, average=average, rng=r1)
        sp, lp = pt.predict(model, pdata, average=average, rng=r2)
        np.testing.assert_allclose(sp, sj, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lp, lj, rtol=2e-4, atol=1e-5)
    # every host draw was made: the two streams are in the same state
    assert r1.integers(1 << 62) == r2.integers(1 << 62)
    assert pt.fused_dispatches == jt.fused_dispatches
    assert (pt.fused_dispatches > 0) == (thr is not None)


def test_dummy_bags_take_no_step():
    """The JAX store pads each bucket's bag count with dummies whose Adam
    step is gated off; the port has no dummies. Both count one Adam step per
    real bag."""
    jbags, pbags = _bags(2, [20, 25, 30])
    jt, pt, (params, ostate), (model, opt) = _pair(None)
    jstore = JStore(jbags)
    assert jstore.buckets[32][0].shape[0] == 8  # 3 real + 5 dummies
    params, ostate, _ = jt.train_epoch(params, ostate, jstore, 1e-3,
                                       np.random.default_rng(0))
    model, opt, _ = pt.train_epoch(model, opt,
                                   DeviceBagStore(pbags, device=CPU), 1e-3,
                                   np.random.default_rng(0))
    assert int(ostate[-1].count) == 3
    steps = {int(s["step"]) for s in opt.state.values()}
    assert steps == {3}
    _assert_params_close(params, model)


def test_patch_dropout_mask_count_is_float64_exact():
    """int(n * p) in float64: f32(2150) * f32(0.94) rounds up across 2021."""
    gen = torch.Generator().manual_seed(0)
    for n, p in ((2150, 0.94), (4096, 0.7), (20000, 0.33), (7, 0.99),
                 (20, 0.5), (20, 1.0)):
        keep = trainer.patch_dropout_mask(gen, n, p, CPU)
        assert keep.dtype == torch.bool and keep.shape == (n,)
        assert int(keep.sum()) == int(n * p), (n, p)
    a = trainer.patch_dropout_mask(torch.Generator().manual_seed(1), 50, 0.5, CPU)
    b = trainer.patch_dropout_mask(torch.Generator().manual_seed(1), 50, 0.5, CPU)
    assert torch.equal(a, b)


def test_patch_dropout_trains_and_draws_like_jax():
    """With patch dropout on, the streams differ (torch vs JAX bits), but
    the host RNG draws and the fused route's refusal are the same."""
    _, pbags = _bags(3, [40, 50, 60, 70])
    jbags, _ = _bags(3, [40, 50, 60, 70])
    jt, pt, (params, ostate), (model, opt) = _pair(16, dropout_patch=0.3)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    jt.train_epoch(params, ostate, JStore(jbags), 1e-3, r1)
    _, _, loss = pt.train_epoch(model, opt, DeviceBagStore(pbags, device=CPU),
                                1e-3, r2)
    assert np.isfinite(loss) and pt.fused_dispatches == 0
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


def test_routing_decisions():
    """_use_fused's eligibility and its "auto" memory rule
    (test_trainer.py:231-298)."""
    cfg = DSMILConfig(feats_size=16, num_classes=1)
    t = 16384
    assert not BagTrainer(cfg, dropout_patch=0.5, fused_threshold=t,
                          device=CPU)._use_fused(65536)
    assert not BagTrainer(cfg, fused_threshold=None,
                          device=CPU)._use_fused(65536)
    assert not BagTrainer(DSMILConfig(16, 1, passing_v=True),
                          fused_threshold=t, device=CPU)._use_fused(65536)
    assert not BagTrainer(DSMILConfig(16, 1, nonlinear=False),
                          fused_threshold=t, device=CPU)._use_fused(65536)
    assert BagTrainer(cfg, fused_threshold=t, device=CPU)._use_fused(t)
    assert not BagTrainer(cfg, fused_threshold=t,
                          device=CPU)._use_fused(t // 2)
    for model in ("abmil", "meanpool", "maxpool",
                  "transmil"):  # DSMIL's pool only
        assert not BagTrainer(cfg, model=model, fused_threshold=t,
                              device=CPU)._use_fused(65536)
    with pytest.raises(ValueError, match="no-such-model"):
        BagTrainer(cfg, model="no-such-model", device=CPU)

    tr = BagTrainer(DSMILConfig(feats_size=512, num_classes=1), device=CPU)
    assert tr.fused_threshold == "auto"
    assert trainer.memory_budget_bytes(CPU) == trainer.HOST_BUDGET_BYTES
    assert trainer.step_workingset_bytes(8192) == \
        2 * trainer.step_workingset_bytes(4096)
    assert trainer.step_workingset_bytes(4096, 1024) == \
        2 * trainer.step_workingset_bytes(4096, 512)
    for n in (4096, 262144, 1 << 20, 1 << 22):
        for b in (1, 2, 8):
            bb = b * n * 512 * 4
            est = bb + trainer.step_workingset_bytes(n)
            assert tr._use_fused(n, bb) == (est > trainer.HOST_BUDGET_BYTES)
    nmax, bucket = 131072, 2 * 131072 * 512 * 4
    assert not tr._use_fused(nmax, bucket)
    tr.extra_resident_bytes = 20 * 2 ** 30
    assert tr._use_fused(nmax, bucket)


def test_auto_routing_is_the_jax_rule(monkeypatch):
    """With the JAX package's v5e working-set constant in place of the
    port's, "auto" decides every bucket as the JAX trainer does."""
    monkeypatch.setattr(trainer, "STEP_BYTES_PER_INSTANCE",
                        jtrainer.XLA_STEP_BYTES_PER_INSTANCE)
    for extra in (0, 10 * 2 ** 30):
        jt = jtrainer.BagTrainer(JCfg(512, 1))
        pt = BagTrainer(DSMILConfig(512, 1), device=CPU)
        jt.extra_resident_bytes = pt.extra_resident_bytes = extra
        for n in (4096, 16384, 131072, 262144, 1 << 20):
            for b in (1, 2, 8):
                bb = b * n * 512 * 4
                assert pt._use_fused(n, bb) == jt._use_fused(n, bb), (n, b)


def test_eval_auto_routes_a_bag_that_does_not_fit(monkeypatch):
    """Under "auto", a bag whose eager eval forward would not fit goes
    through K1 (its plain version here) with the same scores."""
    _, pbags = _bags(4, [200, 300])
    _, pt, _, (model, _) = _pair("auto")
    want, wl = pt.predict(model, pbags)
    assert pt.fused_dispatches == 0
    monkeypatch.setattr(trainer, "EVAL_BYTES_PER_INSTANCE", 2 ** 40)
    got, gl = pt.predict(model, pbags)
    assert pt.fused_dispatches == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-6)


def test_list_and_store_predict_agree():
    _, pbags = _bags(5, SIZES)
    _, pt, _, (model, _) = _pair(None)
    s1, l1 = pt.predict(model, pbags)
    s2, l2 = pt.predict(model, DeviceBagStore(pbags, device=CPU))
    np.testing.assert_allclose(s1, s2, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(l1, l2, rtol=1e-6, atol=1e-7)
    avg, _ = pt.predict(model, pbags, average=True)
    assert np.all(avg >= s1 - 1e-6)


def test_device_store_bookkeeping_matches_jax():
    jbags, pbags = _bags(6, SIZES)
    js, ps = JStore(jbags), DeviceBagStore(pbags, device=CPU)
    assert ps.bucket_sizes == js.bucket_sizes
    for nmax in js.bucket_sizes:
        np.testing.assert_array_equal(ps.index[nmax], js.index[nmax])
        assert ps.counts[nmax] == js.counts[nmax]
    sel = [4, 2, 5, 0, 3]
    jsub, psub = js.subset(sel), ps.subset(sel)
    assert psub.bucket_sizes == jsub.bucket_sizes
    for nmax in jsub.bucket_sizes:
        np.testing.assert_array_equal(psub.index[nmax], jsub.index[nmax])
    np.testing.assert_array_equal(psub.labels, jsub.labels)
    assert psub.names == jsub.names
    for i, g in enumerate(sel):
        np.testing.assert_array_equal(psub.bag(i).numpy(), pbags[g].feats)


def test_init_functions():
    cfg = DSMILConfig(feats_size=40, num_classes=3)
    a = dsmil.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    b = dsmil.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    c = dsmil.init_params(torch.Generator().manual_seed(1), cfg, CPU)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        if k.endswith("bias"):
            assert not v.any()
    assert not torch.equal(a.b_classifier.fcc.weight, c.b_classifier.fcc.weight)
    for w in (a.i_classifier.fc[0].weight, a.b_classifier.q[0].weight,
              a.b_classifier.q[2].weight, a.b_classifier.fcc.weight):
        flat = w.reshape(w.shape[0], -1)  # torch orientation: rows x rest
        if flat.shape[0] > flat.shape[1]:
            flat = flat.T  # a tall weight has orthonormal columns
        torch.testing.assert_close(flat @ flat.T, torch.eye(flat.shape[0]),
                                   rtol=0, atol=1e-5)
    for shape in ((3, 40), (128, 40), (3, 3, 40)):
        want = torch.empty(shape)
        torch.nn.init.orthogonal_(want, generator=torch.Generator().manual_seed(5))
        got = orthogonal_torch(torch.Generator().manual_seed(5), shape)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    t = dsmil.torch_default_init_params(torch.Generator().manual_seed(0), cfg,
                                        CPU)
    for layer in (t.i_classifier.fc[0], t.b_classifier.q[2], t.b_classifier.fcc):
        bound = 1 / np.sqrt(np.prod(layer.weight.shape[1:]))
        assert layer.weight.abs().max() <= bound and layer.bias.abs().max() <= bound
        assert layer.weight.abs().max() > 0.5 * bound


def test_value_dropout_draws_from_the_generator():
    cfg = DSMILConfig(feats_size=16, num_classes=2, passing_v=True,
                      dropout_v=0.5)
    model = dsmil.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    x = torch.randn(30, 16, generator=torch.Generator().manual_seed(1))
    ref = model(x)[1]                        # eval mode: no dropout
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    a = model(x, dropout_generator=torch.Generator().manual_seed(2))[1]
    b = model(x, dropout_generator=torch.Generator().manual_seed(2))[1]
    c = model(x, dropout_generator=torch.Generator().manual_seed(3))[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)
    model.eval()
    assert torch.equal(model(x)[1], ref)


def test_ops_match_jax():
    """masked_mean, the BCE with pos_weight (and its reduction check) and
    the dual-stream loss against tpumil/ops."""
    from tpumil.ops import losses as jlosses
    from tpumil.ops import masked as jmasked
    from tpumil_torch.ops import losses, masked

    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    mask = rng.random((3, 7)) > 0.4
    mask[1] = False  # an all-padding bag gives 0
    got = masked.masked_mean(torch.from_numpy(x), torch.from_numpy(mask), 1)
    want = jmasked.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(masked.masked_mean(torch.from_numpy(x), None,
                                                  1).numpy(),
                               x.mean(axis=1), rtol=1e-6)
    logits = rng.standard_normal((5, 3)).astype(np.float32) * 4
    labels = (rng.random((5, 3)) > 0.5).astype(np.float32)
    pw = np.asarray([0.5, 1.0, 3.0], np.float32)
    for red in ("mean", "sum", "none"):
        for p in (None, pw):
            got = losses.bce_with_logits(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if p is None else torch.from_numpy(p), red)
            want = jlosses.bce_with_logits(jnp.asarray(logits),
                                           jnp.asarray(labels), p, red)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="reduction"):
        losses.bce_with_logits(torch.zeros(2), torch.zeros(2), reduction="Mean")
    got = losses.dual_stream_loss(torch.from_numpy(logits[0]),
                                  torch.from_numpy(logits[1]),
                                  torch.from_numpy(labels[0]),
                                  torch.from_numpy(pw))
    want = jlosses.dual_stream_loss(jnp.asarray(logits[0]),
                                    jnp.asarray(logits[1]),
                                    jnp.asarray(labels[0]), pw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_device_defaults_are_the_card():
    """Left out, the device is the card: without one, every entry point
    that takes a device raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = DSMILConfig(feats_size=16, num_classes=1)
    _, pbags = _bags(7, [10, 20])
    gen = torch.Generator().manual_seed(0)
    for make in (lambda: BagTrainer(cfg),
                 lambda: DeviceBagStore(pbags),
                 lambda: dsmil.init_params(gen, cfg),
                 lambda: dsmil.torch_default_init_params(gen, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
