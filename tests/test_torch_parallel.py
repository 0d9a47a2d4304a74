"""The port's scale-out training (tpumil_torch/parallel/) against the JAX
package's (tpumil/parallel/) and against its own single-device steps:
gloo worlds of 2 and 4 spawned on the CPU (tests/torch_parallel_util.py),
the JAX side in this process on conftest's 8 virtual CPU devices, the
same numpy inputs and, through io/from_jax, the same parameters.

Bars: the forward within rtol 1e-5 / atol 1e-6 of JAX's; parameters after
Adam steps within tests/test_torch_trainer.py's rtol 1e-3 / atol 2e-5;
the data-parallel trainer mesh-invariant within rtol 1e-4 / atol 1e-5
(tests/test_parallel.py's); parameters bitwise equal across ranks."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_parallel_util as util
from tpumil.data.bags import Bag as JBag
from tpumil.data.device_store import DeviceBagStore as JStore
from tpumil.models import dsmil as jdsmil
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.parallel import bag_shard as jbag_shard
from tpumil.train import trainer as jtrainer
from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.io import from_jax
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.ops.losses import dual_stream_loss
from tpumil_torch.parallel import mesh, sharded_train
from tpumil_torch.parallel.bag_shard import InstanceShardedBagTrainer
from tpumil_torch.parallel.sharded_train import DataParallelBagTrainer
from tpumil_torch.train import schemes
from tpumil_torch.train.optim import adam_torch, set_lr
from tpumil_torch.train.trainer import BagTrainer

CPU = torch.device("cpu")


def _jax_params(seed: int, k: int, c: int = 2):
    return jdsmil.init_params(jax.random.PRNGKey(seed), JCfg(k, c))


def _state(params):
    return from_jax.dsmil_state_dict(jax.tree.map(np.asarray, params))


def _close(got: dict, want: dict, rtol=1e-3, atol=2e-5):
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture
def world_of_one():
    """A test that makes a world of one in this process (make_mesh with no
    process group) leaves none behind."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One spawned world of 4 runs every world-4 body of
    torch_parallel_util (util.world4)."""
    states = {"fwd": _state(_jax_params(3, 64)),
              "step": _state(_jax_params(3, 64)),
              "epoch": _state(_jax_params(5, 32))}
    results = util.run_world(4, util.world4, states["fwd"], states["step"],
                             states["epoch"],
                             tmp=tmp_path_factory.mktemp("world4"))
    return states, results


def _eager_steps(state, feats, mask, label, steps=3, lr=2e-3):
    """The single-device eager step on the unpadded bag, the sharded step's
    reference."""
    model = util.dsmil_from(state, feats.shape[1], label.shape[0])
    opt = adam_torch(model.parameters(), weight_decay=1e-3)
    set_lr(opt, lr)
    x = torch.from_numpy(feats[mask])
    y = torch.from_numpy(label)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        c, bag_logits, _, _ = model(x)
        loss = dual_stream_loss(bag_logits, c.amax(0), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, util.params_of(model)


@pytest.mark.parametrize("inst", [2, 4])
def test_sharded_forward_matches_jax(world4, inst):
    """The inst-sharded forward at inst 2 and 4 against JAX's
    make_instance_sharded_forward over the same devices count."""
    states, results = world4
    feats, mask = util.forward_bag()
    jm = Mesh(np.asarray(jax.devices()[:inst]), ("inst",))
    f, m = jbag_shard.shard_bag(jm, jnp.asarray(feats), jnp.asarray(mask))
    want = jbag_shard.make_instance_sharded_forward(jm)(_jax_params(3, 64),
                                                        f, m)
    for r in range(4):
        for got, w in zip(results[r][f"fwd{inst}"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_sharded_steps_match_single_device_and_jax(world4):
    """Three inst-sharded Adam steps at world 4 against the port's eager
    single-device step and JAX's make_instance_sharded_train_step on a
    4-device mesh; parameters bitwise equal across ranks; 6 collective
    calls a step (3 forward, 2 backward, 1 gradient average)."""
    states, results = world4
    feats, mask, label = util.step_bag()
    want_losses, want = _eager_steps(states["step"], feats, mask, label)
    losses, params, calls = results[0]["steps"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(params, want)
    assert calls == 6
    for r in range(1, 4):
        other = results[r]["steps"][1]
        for name, t in params.items():
            assert torch.equal(other[name], t), (r, name)

    jm = Mesh(np.asarray(jax.devices()[:4]), ("inst",))
    step, optimizer = jbag_shard.make_instance_sharded_train_step(jm)
    p = _jax_params(3, 64)
    s = optimizer.init(p)
    f, m = jbag_shard.shard_bag(jm, jnp.asarray(feats), jnp.asarray(mask))
    jlosses = []
    for _ in range(3):
        p, s, loss = step(p, s, f, m, jnp.asarray(label),
                          jnp.asarray(2e-3, jnp.float32),
                          jnp.ones((2,), jnp.float32))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close(params, _state(p))


def test_train_bags_sharded_epoch(world4):
    """A train_bags_sharded epoch at world 4 visits the bags in the
    permutation JAX's train_bags_sharded draws from the same generator and
    matches the unpadded single-device loop in that order."""
    states, results = world4
    bags = util.epoch_bags()
    order = np.random.default_rng(9).permutation(len(bags))
    model = util.dsmil_from(states["epoch"], 32, 2)
    opt = adam_torch(model.parameters(), weight_decay=1e-3)
    set_lr(opt, 2e-3)
    want_losses = []
    for i in order:
        opt.zero_grad()
        c, bag_logits, _, _ = model(torch.from_numpy(bags[i][0]))
        loss = dual_stream_loss(bag_logits, c.amax(0),
                                torch.from_numpy(bags[i][1]))
        loss.backward()
        opt.step()
        want_losses.append(float(loss.detach()))
    losses, params = results[0]["epoch"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(params, util.params_of(model), rtol=1e-4, atol=1e-5)
    for r in range(1, 4):
        for name, t in params.items():
            assert torch.equal(results[r]["epoch"][1][name], t), (r, name)


def test_data_parallel_trainer_is_mesh_invariant(world4, world_of_one):
    """DataParallelBagTrainer at world 1 and at world 4 (data 2 x inst 2)
    on the ragged 5-bag case: the same losses and scores."""
    _, results = world4
    l1, s1, _ = util.data_parallel_run(1)
    l4, s4, p4 = results[0]["dp"]
    np.testing.assert_allclose(l4, l1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s4, s1, rtol=1e-4, atol=1e-5)
    for r in range(1, 4):
        for name, t in p4.items():
            assert torch.equal(results[r]["dp"][2][name], t), (r, name)


def test_data_parallel_step_matches_jax(world_of_one):
    """One minibatch step of make_sharded_train_step (world 1) against
    JAX's on its 8-device (data 4, inst 2) mesh, on tests/test_parallel.py's
    8 masked bags (the port takes each bag's real rows) with 3 count-padding
    dummies gated out by ``real``: the mean loss over the real bags and the
    updated parameters."""
    from tpumil.parallel import mesh as jmesh
    from tpumil.parallel import sharded_train as jsharded

    rng = np.random.default_rng(0)
    b, n, k = 8, 64, 64
    feats = rng.standard_normal((b, n, k)).astype(np.float32)
    mask = rng.random((b, n)) < 0.9
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=b)]
    real = np.arange(b) < 5
    params = _jax_params(0, k)
    jm = jmesh.make_mesh(8)
    step, optimizer = jsharded.make_sharded_train_step(JCfg(k, 2), jm)
    f, m, l = jsharded.device_put_batch(jm, feats, mask, labels)
    p, _, want = step(params, optimizer.init(params), f, m, jnp.asarray(l),
                      1e-3, jnp.asarray(real))

    pstep, make_opt = sharded_train.make_sharded_train_step(
        DSMILConfig(k, 2), mesh.make_mesh(1, device_type="cpu"))
    model = util.dsmil_from(_state(_jax_params(0, k)), k, 2)
    opt = make_opt(model.parameters())
    model, opt, got = pstep(
        model, opt, [torch.from_numpy(feats[i][mask[i]]) for i in range(b)],
        torch.from_numpy(labels), lr=1e-3, real=real)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(util.params_of(model), _state(p))


def test_world_size_refusals(world4):
    """Inside a world of 4: a mesh of 2 or 8, or an indivisible inst axis,
    raises with the JAX package's wording, and an inst axis wider than a
    node's ranks is refused; make_hybrid_mesh over two nodes of 2 keeps
    each inst group inside one node."""
    _, results = world4
    for r in range(4):
        (e2, e8, e3, cross), (shape, inst, data) = results[r]["errors"]
        assert "requested 2 devices but the process group holds 4" in e2
        assert "requested 8 devices but only 4 are available" in e8
        assert "not divisible by inst_parallel=3" in e3
        assert "would cross a node of 2 local ranks" in cross
        assert shape == (2, 2)
        assert inst == [2 * (r // 2), 2 * (r // 2) + 1]
        assert data == [r % 2, r % 2 + 2]


def test_sharded_state_resumes_across_world_sizes(tmp_path, world_of_one):
    """A sharded train state saved at world 2 (rank 0 writes, every rank
    waits) resumes at world 1 on the uninterrupted world-2 trajectory."""
    state = _state(_jax_params(2, 32))
    path = str(tmp_path / "state")
    full = util.run_world(2, util.world2, state, path, tmp=tmp_path)
    for name, t in full[0].items():
        assert torch.equal(full[1][name], t), name
    resumed = util.resume_epochs(path)
    _close(resumed, full[0], rtol=1e-4, atol=1e-5)
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("state")) == ["state"]


def test_validation_errors(world_of_one):
    """Every refusal of the sharded trainers, steps, configs and meshes,
    before any work."""
    cfg = DSMILConfig(16, 1)
    stub = lambda dp, sp: types.SimpleNamespace(  # noqa: E731
        shape=(dp, sp), mesh_dim_names=("data", "inst"))
    with pytest.raises(ValueError, match="requires a mesh"):
        InstanceShardedBagTrainer(cfg, device=CPU)
    with pytest.raises(ValueError, match="power of two"):
        InstanceShardedBagTrainer(cfg, device=CPU, mesh=stub(1, 3))
    for kw, msg in (({"dropout_patch": 0.5}, "dropout"),
                    ({"cfg": DSMILConfig(16, 1, passing_v=True)}, "passing_v"),
                    ({"model": "abmil"}, "only model='dsmil'")):
        with pytest.raises(NotImplementedError, match=msg):
            InstanceShardedBagTrainer(**{"cfg": cfg, **kw}, device=CPU,
                                      mesh=stub(1, 2))
    with pytest.raises(ValueError, match="mesh"):
        DataParallelBagTrainer(cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="dropout"):
        DataParallelBagTrainer(cfg, device=CPU, mesh=stub(2, 2),
                               dropout_patch=0.5)
    with pytest.raises(ValueError, match="powers of two"):
        DataParallelBagTrainer(cfg, device=CPU, mesh=stub(3, 1))
    with pytest.raises(NotImplementedError, match="dropout"):
        sharded_train.make_sharded_train_step(
            DSMILConfig(16, 1, passing_v=True, dropout_v=0.2), stub(1, 1))
    # the two modes exclude each other; both are refused before a mesh
    for kw in ({"inst_shard": 2, "data_parallel": 2},):
        with pytest.raises(ValueError, match="mutually exclusive"):
            schemes._make_trainer(schemes.WSITrainConfig(
                feats_size=16, num_classes=1, device=CPU, **kw))
    with pytest.raises(ValueError, match="power of two"):
        schemes.check_config(schemes.WSITrainConfig(inst_shard=3))
    with pytest.raises(NotImplementedError, match="dropout"):
        schemes.check_config(schemes.WSITrainConfig(data_parallel=2,
                                                    dropout_patch=0.1))
    # no process group: a world of more than one is never made here
    with pytest.raises(ValueError, match="needs a process group of 2"):
        schemes._make_trainer(schemes.WSITrainConfig(
            feats_size=16, num_classes=1, device=CPU, inst_shard=2))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="non-negative"):
        mesh.take_devices(-1, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 2 devices but only "
                                             "0 are available"):
            mesh.take_devices(2, "cuda")
    with pytest.raises(ValueError, match="whole cluster"):
        mesh.init_distributed("localhost:1", device_type="cpu")
    mesh.init_distributed(device_type="cpu")  # no cluster: a no-op
    assert not dist.is_initialized()
    # a world of one is made on demand, and then refuses another device
    tr = InstanceShardedBagTrainer(cfg, device=CPU,
                                   mesh=mesh.make_mesh(1, 1, "cpu"))
    assert tr.min_bucket == 16 and tr.fused_threshold is None
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="holds 1 ranks"):
        mesh.make_mesh(0, device_type="cpu")


def test_sequential_epochs_draws_as_jax(world_of_one):
    """The sharded trainers' train_epochs on a single-bucket store draws the
    host RNG as the JAX package's sequential_epochs: all E permutations,
    then one integer; the bags visited are JAX's, in JAX's order, and the
    trajectory is BagTrainer's (world 1)."""
    rng = np.random.default_rng(0)
    raw = [(rng.standard_normal((16, 16)).astype(np.float32),
            np.asarray([float(i % 2)], np.float32), f"b{i}")
           for i in range(10)]
    lrs = [1e-3, 1e-3, 1e-3]

    jstore = JStore([JBag(*b) for b in raw])
    (nmax,) = jstore.bucket_sizes
    jvisits = []

    def record(params, opt_state, feats, mask, labels, perm, lr, keys, real,
               n, resident_bytes=None):
        perm, real = np.asarray(perm), np.asarray(real)
        jvisits.extend(jstore.index[n][perm[real]].tolist())
        return params, opt_state, jnp.zeros(())

    fake = types.SimpleNamespace(_bucket_perm=jtrainer.BagTrainer._bucket_perm,
                                 _train_bucket_any=record)
    jrng = np.random.default_rng(7)
    jtrainer.sequential_epochs(fake, None, None, jstore, lrs, jrng)

    store = DeviceBagStore([Bag(*b) for b in raw], device=CPU)
    cfg = DSMILConfig(16, 1)
    sharded = InstanceShardedBagTrainer(cfg, weight_decay=1e-3, device=CPU,
                                        mesh=mesh.make_mesh(1, 1, "cpu"))
    visits = []
    inner = sharded._inst_step

    def counting(model, opt, f, m, label, **kw):
        visits.append(int(np.searchsorted(store.offsets,
                                          (f.data_ptr() - store.feats.data_ptr())
                                          // (4 * 16))))
        return inner(model, opt, f, m, label, **kw)

    sharded._inst_step = counting
    prng = np.random.default_rng(7)
    model, opt = sharded.init(torch.Generator().manual_seed(0))
    model, opt, losses = sharded.train_epochs(model, opt, store, lrs, prng)
    assert visits == jvisits and len(visits) == 3 * len(raw)
    assert prng.bit_generator.state == jrng.bit_generator.state

    base = BagTrainer(cfg, weight_decay=1e-3, fused_threshold=None,
                      device=CPU)
    bmodel, bopt = base.init(torch.Generator().manual_seed(0))
    bmodel, bopt, blosses = base.train_epochs(bmodel, bopt, store, lrs,
                                              np.random.default_rng(7))
    np.testing.assert_allclose(losses, blosses, rtol=1e-4, atol=1e-5)
    _close(util.params_of(model), util.params_of(bmodel))
