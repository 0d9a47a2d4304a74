"""The aggregators' compute dtype in the port (``DSMILConfig.compute_dtype``,
``forward(..., compute_dtype=)``, ``DeviceBagStore(dtype=)``) against the
JAX package's, on the CPU: the masked reductions and every registry
model's forward in bf16, BagTrainer's bf16 epoch, its routing gate, a bf16
store on both routes, ``MILNet.score``, and ``native.decode_batch``'s
``as_float``/``allow_resize``. The sharded trainers' bf16 steps run in
tests/test_torch_parallel.py's gloo worlds.

Bars: a bf16 forward output lies at most half as far from JAX's bf16 output
as JAX's f32 output does (L2 norms), a critical instance at a JAX near-tie
(top two logits within 2 bf16 ulps) may be either; a bf16 epoch's losses
within rtol 1e-2 of JAX's; an f32 config over a bf16 store within rtol
1e-2 of the f32 store's losses."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.data.bags import Bag as JBag
from tpumil.data.device_store import DeviceBagStore as JStore
from tpumil.models.dsmil import DSMILConfig as JCfg
from tpumil.models.milnet import MILNet as JMILNet
from tpumil.models.registry import get_model as jget_model
from tpumil.ops import masked as jmasked
from tpumil.train import optim as joptim
from tpumil.train import trainer as jtrainer
from tpumil.utils import native as jnative
from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.io import from_jax
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.milnet import MILNet
from tpumil_torch.models.registry import get_model
from tpumil_torch.ops import attention_pool as ap
from tpumil_torch.ops import masked
from tpumil_torch.train.trainer import BagTrainer
from tpumil_torch.utils import native

CPU = torch.device("cpu")
BF16 = torch.bfloat16
K, N = 32, 128
# (model, nonlinear, passing_v, C)
MODELS = [("dsmil", True, False, 2), ("dsmil", True, True, 1),
          ("dsmil", False, False, 1), ("dsmil", False, True, 2),
          ("abmil", True, False, 2), ("meanpool", True, False, 1),
          ("maxpool", True, False, 2)]


def _np(x) -> np.ndarray:
    """A JAX array or a tensor of any float dtype as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return np.dtype(x.dtype).name


def _jax_params(model, c, seed, **cfg_kw):
    """The JAX init with every bias drawn nonzero, so that the bias adds'
    rounding is exercised."""
    params = jax.tree.map(np.asarray, jget_model(model).init_params(
        jax.random.PRNGKey(seed), JCfg(K, c, **cfg_kw)))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * rng.standard_normal(v.shape)).astype(
            np.float32) if str(path[-1].key).startswith("b") else v, params)


def _port(model, params, cfg):
    net = get_model(model)(cfg, CPU)
    net.load_state_dict(from_jax.mil_state_dict(params, model), strict=True)
    return net


def test_masked_ops_in_bf16_match_jax():
    """masked_max / masked_argmax / masked_softmax / masked_mean in bf16,
    bitwise JAX's: the -1e30 sentinel is finite in bf16, an all-padding
    row's softmax denominator is floored at bf16's tiny, ties at the
    maximum go to the lowest index."""
    assert np.isfinite(float(torch.tensor(masked.NEG_INF, dtype=BF16)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, N, 2)).astype(np.float32)  # the forwards'
    x[0, [2, 5, 7], 1] = 9.0                     # a tie at the maximum
    x[0, :, 0] = 0.5                             # a column of ties
    mask = rng.random((2, N)) > 0.3
    mask[0, [2, 5, 7]] = True
    mask[1] = False                              # an all-padding bag
    xt, xj = torch.from_numpy(x).to(BF16), jnp.asarray(x).astype(jnp.bfloat16)
    for m in (None, mask):
        mt = None if m is None else torch.from_numpy(m)
        mj = None if m is None else jnp.asarray(m)
        for name in ("masked_max", "masked_argmax", "masked_softmax",
                     "masked_mean"):
            got = getattr(masked, name)(xt, mt, dim=1)
            want = getattr(jmasked, name)(xj, mj, axis=1)
            if name == "masked_argmax":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                continue
            assert got.dtype == BF16 and _dtype_name(want) == "bfloat16"
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)
    assert masked.masked_argmax(xt, None, dim=1)[0].tolist() == [0, 2]
    soft = masked.masked_softmax(xt, torch.from_numpy(mask), dim=1)
    assert not soft[1].any() and torch.isfinite(soft).all()


def _crit_near_ties(jc, mask):
    """Bags whose critical instance JAX picks at a near-tie: the top two
    masked instance logits of some class within 2 bf16 ulps."""
    c = _np(jc)
    if mask is not None:
        c = np.where(mask[..., None], c, -np.inf)
    top2 = -np.sort(-c, axis=1)[:, :2]                    # [B, 2, C]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 0]))) - 7)
    return {b for b in range(c.shape[0])
            if np.any(top2[b, 0] - top2[b, 1] < 2 * ulp[b])}


@pytest.mark.parametrize("with_logits", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("model,nonlinear,passing_v,c", MODELS)
def test_forward_in_bf16_matches_jax(model, nonlinear, passing_v, c,
                                     with_mask, with_logits):
    """``forward(..., compute_dtype=bfloat16)`` of each registry model (DSMIL
    over nonlinear x passing_v) against the JAX model's, with and without a
    padding mask and precomputed instance logits: JAX's output dtypes, the
    norm bar, and an output unlike the f32 forward's."""
    seed = len(model) + 2 * nonlinear + passing_v
    rng = np.random.default_rng(seed)
    kw = dict(nonlinear=nonlinear, passing_v=passing_v)
    params = _jax_params(model, c, seed, **kw)
    net = _port(model, params, DSMILConfig(K, c, **kw))
    feats = rng.standard_normal((2, N, K)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.ones((2, N), bool)
        mask[1, 77:] = False
    logits = rng.standard_normal((2, N, c)).astype(np.float32) \
        if with_logits else None
    jfwd = jget_model(model).forward
    jargs = (params, jnp.asarray(feats), None if mask is None
             else jnp.asarray(mask))
    jkw = {} if logits is None else {"ins_logits": jnp.asarray(logits)}
    want32 = jfwd(*jargs, **jkw)
    want = jfwd(*jargs, compute_dtype=jnp.bfloat16, **jkw)
    pargs = (torch.from_numpy(feats), None if mask is None
             else torch.from_numpy(mask))
    pkw = {} if logits is None else {"ins_logits": torch.from_numpy(logits)}
    with torch.no_grad():
        got = net(*pargs, compute_dtype=BF16, **pkw)
        got32 = net(*pargs, **pkw)
    assert [_dtype_name(g) for g in got] == [_dtype_name(w) for w in want] \
        == ["bfloat16"] * 4
    assert [g.dtype for g in got32] == [torch.float32] * 4

    keep = list(range(2))
    if model in ("dsmil", "maxpool"):  # outputs that hang on the argmax
        jc = want[0]
        crit = masked.masked_argmax(got[0], pargs[1], dim=1).numpy()
        jcrit = np.asarray(jmasked.masked_argmax(jc, jargs[2], axis=1))
        ties = _crit_near_ties(jc, mask)
        for b in np.nonzero((crit != jcrit).any(axis=1))[0]:
            assert b in ties, f"bag {b}: critical instance {crit[b]} vs " \
                              f"JAX's {jcrit[b]} at no near-tie"
            keep.remove(b)
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        rows = slice(None) if i == 0 else keep
        g, w, w32 = _np(g)[rows], _np(w)[rows], _np(w32)[rows]
        gap, bf16_err = np.linalg.norm(g - w), np.linalg.norm(w32 - w)
        assert gap <= 0.5 * bf16_err, \
            f"output {i}: |port - jax bf16| / |jax f32 - jax bf16| = " \
            f"{gap / bf16_err if bf16_err else float('inf'):.3f}"
    assert not np.array_equal(_np(got[1]), _np(got32[1]))


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


# one bucket of 32 rows: one compiled shape on the JAX side
SIZES = [20, 25, 30, 17, 28, 22]


def _port_trainer(dtype, thr, **kw):
    return BagTrainer(DSMILConfig(K, 2, compute_dtype=dtype),
                      weight_decay=1e-3, fused_threshold=thr, chunk_size=8,
                      device=CPU, **kw)


def _model_from(params):
    return _port("dsmil", params, DSMILConfig(K, 2))


@pytest.fixture(scope="module")
def jax_bf16_trainer():
    """One JAX trainer with a bf16 config for both data paths: its jitted
    steps compile once for the bucket's shape."""
    return jtrainer.BagTrainer(
        JCfg(K, 2, compute_dtype=jnp.bfloat16), chunk_size=8,
        fused_threshold=16,
        optimizer=joptim.adam_torch(betas=(0.5, 0.9), weight_decay=1e-3))


@pytest.mark.parametrize("path", ["list", "store"])
def test_bf16_epoch_matches_jax(path, jax_bf16_trainer):
    """One bf16 BagTrainer epoch and predict against the JAX trainer's with
    a bf16 config, from the same parameters and host seed, with
    fused_threshold=16 (every bucket would qualify): neither routes to the
    kernels, the losses agree within rtol 1e-2 and differ from the f32
    epoch's, and the parameters, gradients and Adam's moments stay f32."""
    jbags, pbags = _bags(0, SIZES)
    params = jax.tree.map(np.asarray, jget_model("dsmil").init_params(
        jax.random.PRNGKey(0), JCfg(K, 2)))
    jt = jax_bf16_trainer
    jdata = jbags if path == "list" else JStore(jbags)
    pdata = pbags if path == "list" else DeviceBagStore(pbags, device=CPU)
    jp = jax.tree.map(jnp.asarray, params)
    js = jt.optimizer.init(jp)
    r1 = np.random.default_rng(5)
    jp, js, want = jt.train_epoch(jp, js, jdata, 1e-3, r1)
    wscores, wlosses = jt.predict(jp, jdata, rng=r1)

    got = {}
    for dtype in (torch.float32, BF16):
        pt = _port_trainer(dtype, 16)
        model = _model_from(params)
        opt = pt.make_optimizer(model)
        r2 = np.random.default_rng(5)
        model, opt, loss = pt.train_epoch(model, opt, pdata, 1e-3, r2)
        scores, losses = pt.predict(model, pdata, rng=r2)
        got[dtype] = (loss, scores, losses)
        assert pt.fused_dispatches == int(dtype == torch.float32) * 2
    assert jt.fused_dispatches == 0
    loss, scores, losses = got[BF16]
    np.testing.assert_allclose(loss, want, rtol=1e-2)
    np.testing.assert_allclose(losses, wlosses, rtol=1e-2)
    np.testing.assert_allclose(scores, np.asarray(wscores, np.float32),
                               atol=2e-2)
    assert loss != got[torch.float32][0]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {t.dtype for st in opt.state.values() for t in st.values()
            if t.dim() > 0} == {torch.float32}


def test_bf16_config_never_routes_to_kernels():
    """tests/test_trainer.py:231-243's gate: a bf16 config stays on the
    eager route whatever fused_threshold says, as the JAX trainer's does;
    the same f32 config routes."""
    t = 16384
    cfg32 = DSMILConfig(16, 1)
    cfg16 = DSMILConfig(16, 1, compute_dtype=BF16)
    assert BagTrainer(cfg32, fused_threshold=t, device=CPU)._use_fused(65536)
    assert not BagTrainer(cfg16, fused_threshold=t,
                          device=CPU)._use_fused(65536)
    assert not jtrainer.BagTrainer(
        JCfg(16, 1, compute_dtype=jnp.bfloat16),
        fused_threshold=t)._use_fused(65536)
    auto = BagTrainer(cfg16, device=CPU)
    auto.extra_resident_bytes = 1 << 60  # "auto" would need the kernels
    assert not auto._use_fused(65536) and not auto._use_fused_eval(65536)


def test_bf16_store_trains_on_both_routes():
    """An f32 config over a bf16 DeviceBagStore: the kernel route (their
    plain versions here; fused_bag_loss/fused_bag_forward take the bag in
    f32) and the eager route each train within rtol 1e-2 of the f32 store's
    losses; fused_bag_forward of a bf16 bag is that of its f32 copy."""
    _, pbags = _bags(1, [40, 50, 70, 60])
    params = jax.tree.map(np.asarray, jget_model("dsmil").init_params(
        jax.random.PRNGKey(1), JCfg(K, 2)))
    runs = {}
    for dtype in (torch.float32, BF16):
        store = DeviceBagStore(pbags, device=CPU, dtype=dtype)
        for thr in (16, None):
            pt = _port_trainer(torch.float32, thr)
            model = _model_from(params)
            opt = pt.make_optimizer(model)
            rng = np.random.default_rng(3)
            model, opt, loss = pt.train_epoch(model, opt, store, 1e-3, rng)
            scores, losses = pt.predict(model, store, rng=rng)
            assert pt.fused_dispatches == (4 if thr else 0)
            runs[dtype, thr] = (loss, scores, losses)
    for thr in (16, None):
        (l16, s16, ls16), (l32, s32, ls32) = runs[BF16, thr], \
            runs[torch.float32, thr]
        np.testing.assert_allclose(l16, l32, rtol=1e-2)
        np.testing.assert_allclose(ls16, ls32, rtol=1e-2)
        np.testing.assert_allclose(s16, s32, atol=1e-2)
    store = DeviceBagStore(pbags, device=CPU, dtype=BF16)
    model = _model_from(params)
    bag = store.bag(2)
    for got, want in zip(ap.fused_bag_forward(model, bag),
                         ap.fused_bag_forward(model, bag.float())):
        assert torch.equal(got, want)


def test_bf16_store_matches_jax():
    """DeviceBagStore(dtype=bfloat16) against JAX's DeviceBagStore(dtype=
    jnp.bfloat16): the same bookkeeping, the features bitwise JAX's rows
    and half the f32 store's bytes (JAX's feature bytes halve too); a
    subset keeps the dtype."""
    jbags, pbags = _bags(2, [10, 30, 60, 45, 100, 14])
    j32, j16 = JStore(jbags), JStore(jbags, dtype=jnp.bfloat16)
    p32 = DeviceBagStore(pbags, device=CPU)
    p16 = DeviceBagStore(pbags, device=CPU, dtype=BF16)
    assert p16.feats.dtype == BF16 and p32.feats.dtype == torch.float32
    assert p16.bucket_sizes == j16.bucket_sizes
    for nmax in j16.bucket_sizes:
        np.testing.assert_array_equal(p16.index[nmax], j16.index[nmax])
        assert p16.counts[nmax] == j16.counts[nmax]
        jf = j16.buckets[nmax][0]
        assert _dtype_name(jf) == "bfloat16"
        for row, g in enumerate(j16.index[nmax]):
            n = pbags[g].num_instances
            np.testing.assert_array_equal(_np(p16.bag(g)),
                                          _np(jf[row, :n]))
    np.testing.assert_array_equal(p16.labels, j16.labels)
    feat32 = int(p32.feats.nbytes)
    assert 2 * p16.feats.nbytes == feat32
    assert p16.nbytes() == p32.nbytes() - feat32 // 2
    jfeat32 = sum(int(f.nbytes) for f, _, _ in j32.buckets.values())
    assert j16.nbytes() == j32.nbytes() - jfeat32 // 2
    sub = p16.subset([4, 1, 3])
    assert sub.feats.dtype == BF16
    assert torch.equal(sub.bag(0), p16.bag(4))


@pytest.mark.parametrize("average", [False, True])
def test_milnet_score_in_bf16_matches_jax(average):
    """MILNet(module, bf16 config).score returns float32 values equal to the
    JAX facade's bf16 scores; the f32 facade's differ."""
    params = _jax_params("dsmil", 2, 4)
    cfg16 = DSMILConfig(K, 2, compute_dtype=BF16)
    net = MILNet(_port("dsmil", params, DSMILConfig(K, 2)), cfg16)
    jnet = JMILNet(jax.tree.map(jnp.asarray, params),
                   JCfg(K, 2, compute_dtype=jnp.bfloat16))
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, N, K)).astype(np.float32)
    mask = rng.random((2, N)) > 0.2
    got = net.score(feats, mask, average=average)
    want = jnet.score(feats, mask, average=average)
    assert got.dtype == np.float32 and _dtype_name(want) == "bfloat16"
    np.testing.assert_array_equal(got, want.astype(np.float32))
    f32 = MILNet(net.module, DSMILConfig(K, 2)).score(feats, mask,
                                                      average=average)
    assert not np.array_equal(got, f32)
    assert all(t.dtype == BF16 for t in net(feats, mask))


# -- native.decode_batch -----------------------------------------------------

class _FakeLib:
    """A stand-in for the tile service's ts_decode_batch: writes a pattern
    into the uint8 buffer (and its /255 into the float buffer, when one is
    passed), -4 for every odd path unless resizing is allowed."""

    def __init__(self):
        self.calls = []

    def ts_decode_batch(self, arr, n, size, out_u8, out_f, err, threads,
                        allow_resize):
        self.calls.append((out_f is not None, allow_resize))
        u8 = np.ctypeslib.as_array(ctypes.cast(out_u8, ctypes.POINTER(
            ctypes.c_uint8)), (n, size, size, 3))
        e = np.ctypeslib.as_array(ctypes.cast(err, ctypes.POINTER(
            ctypes.c_int32)), (n,))
        u8[:] = (np.arange(u8.size) % 251).reshape(u8.shape)
        e[:] = [0 if allow_resize or i % 2 == 0 else -4 for i in range(n)]
        if out_f is not None:
            f = np.ctypeslib.as_array(ctypes.cast(out_f, ctypes.POINTER(
                ctypes.c_float)), (n, size, size, 3))
            f[:] = u8 / np.float32(255.0)
        return 0


@pytest.mark.parametrize("allow_resize", [False, True])
@pytest.mark.parametrize("as_float", [None, False, True])
def test_decode_batch_options_reach_the_library_as_jax(monkeypatch, as_float,
                                                        allow_resize):
    """decode_batch passes as_float (default True) and allow_resize (default
    False) to ts_decode_batch as the JAX wrapper does, and returns what it
    returns: float32 in [0, 1] or uint8, and the error codes."""
    out = []
    for mod in (native, jnative):
        lib = _FakeLib()
        monkeypatch.setattr(mod, "_LIB", lib)
        kw = {"allow_resize": allow_resize}
        if as_float is not None:
            kw["as_float"] = as_float
        out.append((mod.decode_batch(["a.jpg", "b.jpg", "c.jpg"], 8, 2, **kw),
                    lib.calls))
    ((img, err), calls), ((jimg, jerr), jcalls) = out
    assert calls == jcalls == [(as_float is not False, allow_resize)]
    assert img.dtype == jimg.dtype == (np.uint8 if as_float is False
                                       else np.float32)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(err, jerr)
    assert err.dtype == np.int32 and (err == -4).any() != allow_resize


@pytest.mark.skipif(not jnative.available(),
                    reason="native tile service not built")
def test_decode_batch_options_match_jax(tmp_path):
    """With the built library: as_float and allow_resize on JPEGs of the
    target size and of another size, against tpumil.utils.native."""
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i, size in enumerate((32, 32, 48)):
        p = str(tmp_path / f"p{i}.jpg")
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(
            np.uint8)).save(p, quality=95)
        paths.append(p)
    for as_float in (False, True):
        for allow_resize in (False, True):
            got, err = native.decode_batch(paths, 32, 2, as_float=as_float,
                                           allow_resize=allow_resize)
            want, jerr = jnative.decode_batch(paths, 32, 2,
                                              as_float=as_float,
                                              allow_resize=allow_resize)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(err, jerr)
            assert (err[2] == -4) != allow_resize
