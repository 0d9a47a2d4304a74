"""The port's attention pool (tpumil_torch/ops/attention_pool.py: the plain
versions of K1, K2, K3 and the TrainablePool autograd Function) against the
JAX package's Pallas kernels in interpret mode (tpumil/ops/dsmil_pallas.py),
on the same numpy inputs. Bars are test_pallas_backward.py's: loss rtol
1e-4, gradients rtol 5e-3 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.models import dsmil as jdsmil
from tpumil.ops import dsmil_pallas as jpool
from tpumil_torch.io import from_jax
from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
from tpumil_torch.ops import attention_pool as ap

K, C, D = 96, 2, ap.ATTN_DIM
TILE = 128
CPU = torch.device("cpu")


def _inputs(n, n_valid, nonlinear, seed=0):
    rng = np.random.default_rng(seed)
    feats = np.zeros((n, K), np.float32)
    feats[:n_valid] = rng.standard_normal((n_valid, K)) * 0.5
    w = {"w0": rng.standard_normal((D, K)) * 0.1,
         "b0": rng.standard_normal((D,)) * 0.1,
         "w2": rng.standard_normal((D, D)) * 0.1,
         "b2": rng.standard_normal((D,)) * 0.1}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    if not nonlinear:
        w["w2"] = np.zeros((D, D), np.float32)
        w["b2"] = np.zeros((D,), np.float32)
    q_max = (rng.standard_normal((C, D)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((C, K)).astype(np.float32)
    return feats, w, q_max, cot


def _torch_weights(w, nonlinear):
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    return [t["w0"], t["b0"], t["w2"] if nonlinear else None,
            t["b2"] if nonlinear else None]


CASES = [(True, 256, 256), (True, 384, 300), (False, 256, 256),
         (False, 384, 300)]


@pytest.mark.parametrize("nonlinear,n,n_valid", CASES)
def test_forward_matches_pallas(nonlinear, n, n_valid):
    """K1's plain version: B, the softmax stats (m, s), and the logits it
    keeps for K2 against q(feats) q_max^T / sqrt(D) from the JAX model's
    query stream (apply_q), masked past n_valid."""
    feats, w, q_max, _ = _inputs(n, n_valid, nonlinear)
    qp = w if nonlinear else {"w": w["w0"], "b": w["b0"]}
    want, wm, ws = jpool.fused_attention_pool(
        jnp.asarray(feats), jax.tree.map(jnp.asarray, qp), jnp.asarray(q_max),
        n_valid, tile_n=TILE, nonlinear=nonlinear, interpret=True,
        return_stats=True)
    q = jdsmil.apply_q({"q": jax.tree.map(jnp.asarray, qp)},
                       jnp.asarray(feats))
    want_l = np.asarray(jnp.matmul(q, jnp.asarray(q_max).T,
                                   precision=jax.lax.Precision.HIGHEST))
    want_l = np.where(np.arange(n)[:, None] < n_valid, want_l / np.sqrt(D),
                      np.float32(-1e30))
    before = ap.attention_pool_fwd.launches
    got, m, s, logits = ap.attention_pool_fwd(torch.from_numpy(feats),
                                              *_torch_weights(w, nonlinear),
                                              torch.from_numpy(q_max),
                                              n_valid, nonlinear)
    assert ap.attention_pool_fwd.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws)[0], rtol=1e-4)
    assert logits.shape == (n, C)
    np.testing.assert_allclose(logits.numpy(), want_l, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nonlinear,n,n_valid", CASES)
def test_trainable_pool_matches_pallas_backward(nonlinear, n, n_valid):
    """TrainablePool (forward K1, backward K2 on K1's saved logits, then K3;
    their plain versions here) against make_trainable_pool's custom VJP,
    under a random cotangent."""
    feats, w, q_max, cot = _inputs(n, n_valid, nonlinear)
    pool = jpool.make_trainable_pool(tile_n=TILE, nonlinear=nonlinear,
                                     interpret=True)

    def loss_j(f, w0, b0, w2, b2, qm):
        out = pool(f, w0, b0, w2, b2, qm, jnp.asarray([n_valid], jnp.int32))
        return jnp.sum(out * cot)

    args = [feats, w["w0"], w["b0"], w["w2"], w["b2"], q_max]
    want_loss, want_grads = jax.value_and_grad(
        loss_j, argnums=tuple(range(6)))(*map(jnp.asarray, args))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    w2, b2 = (leaves[3], leaves[4]) if nonlinear else (None, None)
    before = (ap.attention_pool_bwd1.launches, ap.attention_pool_bwd2.launches)
    out = ap.TrainablePool.apply(leaves[0], leaves[1], leaves[2], w2, b2,
                                 leaves[5], n_valid, nonlinear)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert (ap.attention_pool_bwd1.launches,
            ap.attention_pool_bwd2.launches) == before
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    names = ["feats", "w0", "b0", "w2", "b2", "q_max"]
    for name, leaf, g in zip(names, leaves, want_grads):
        if not nonlinear and name in ("w2", "b2"):
            assert leaf.grad is None  # unused by the linear q
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=5e-3, atol=1e-5,
                                   err_msg=f"grad of {name}")
    np.testing.assert_array_equal(leaves[0].grad.numpy()[n_valid:], 0.0)


@pytest.mark.parametrize("nonlinear,n,n_valid", CASES)
def test_trainable_pool_without_feats_grad_matches_pallas(nonlinear, n,
                                                           n_valid,
                                                           monkeypatch):
    """Feats that need no gradient (precomputed bag features, as in
    training): the weight gradients still match make_trainable_pool's
    custom VJP, feats get no gradient, and K3 is asked for no dF."""
    feats, w, q_max, cot = _inputs(n, n_valid, nonlinear, seed=7)
    pool = jpool.make_trainable_pool(tile_n=TILE, nonlinear=nonlinear,
                                     interpret=True)

    def loss_j(w0, b0, w2, b2, qm):
        out = pool(jnp.asarray(feats), w0, b0, w2, b2, qm,
                   jnp.asarray([n_valid], jnp.int32))
        return jnp.sum(out * cot)

    args = [w["w0"], w["b0"], w["w2"], w["b2"], q_max]
    want_loss, want_grads = jax.value_and_grad(
        loss_j, argnums=tuple(range(5)))(*map(jnp.asarray, args))

    asked = []
    bwd2 = ap.attention_pool_bwd2

    def spy(*a, **kw):
        out = bwd2(*a, **kw)
        asked.append(out[0] is not None)
        return out

    monkeypatch.setattr(ap, "attention_pool_bwd2", spy)
    f = torch.from_numpy(feats)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    w2, b2 = (leaves[2], leaves[3]) if nonlinear else (None, None)
    out = ap.TrainablePool.apply(f, leaves[0], leaves[1], w2, b2, leaves[4],
                                 n_valid, nonlinear)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert asked == [False] and f.grad is None
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    for name, leaf, g in zip(["w0", "b0", "w2", "b2", "q_max"], leaves,
                             want_grads):
        if not nonlinear and name in ("w2", "b2"):
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=5e-3, atol=1e-5,
                                   err_msg=f"grad of {name}")


@pytest.mark.parametrize("nonlinear", [True, False])
def test_bwd2_without_df_keeps_the_other_gradients(nonlinear):
    """K3's plain version honours need_df: no dF, and every other gradient
    bit for bit that of the call that computes dF."""
    feats, w, q_max, cot = _inputs(384, 300, nonlinear, seed=8)
    f, qm, db = map(torch.from_numpy, (feats, q_max, cot))
    ws = _torch_weights(w, nonlinear)
    _, m, s, logits = ap.attention_pool_fwd(f, *ws, qm, 300, nonlinear)
    red = ap.attention_pool_bwd1(f, logits, m, s, db, 300)
    full = ap.attention_pool_bwd2(f, *ws, qm, m, s, db, red, 300, nonlinear)
    part = ap.attention_pool_bwd2(f, *ws, qm, m, s, db, red, 300, nonlinear,
                                  need_df=False)
    assert full[0].shape == (384, K) and part[0] is None
    for a, b in zip(full[1:], part[1:]):
        assert torch.equal(a, b)


def _models(seed=0, k=K, c=C):
    params = jdsmil.init_params(jax.random.PRNGKey(seed),
                                jdsmil.DSMILConfig(feats_size=k, num_classes=c))
    params = jax.tree.map(np.asarray, params)
    model = DSMIL(DSMILConfig(feats_size=k, num_classes=c), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params))
    return params, model


@pytest.mark.parametrize("n,n_valid", [(128, 128), (256, 200)])
def test_fused_bag_loss_matches_jax(n, n_valid):
    """The dual-stream loss through the pool and its parameter gradients,
    against make_fused_bag_loss; q_max = q(feats[crit]) stays in autograd
    on both sides."""
    feats, _, _, _ = _inputs(n, n_valid, True, seed=3)
    params, model = _models()
    label = np.asarray([0.0, 1.0], np.float32)
    pw = np.asarray([1.5, 0.5], np.float32)
    pool = jpool.make_trainable_pool(tile_n=TILE, interpret=True)
    loss_fn = jpool.make_fused_bag_loss(pool)
    want, grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(feats),
        jnp.asarray([n_valid], jnp.int32), jnp.asarray(label), jnp.asarray(pw))
    loss = ap.fused_bag_loss(model, torch.from_numpy(feats[:n_valid]),
                             torch.from_numpy(label), torch.from_numpy(pw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    got = from_jax.dsmil_params({k: p.grad for k, p in
                                 model.named_parameters()})
    for (path, g), x in zip(jax.tree.leaves_with_path(grads),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(x, np.asarray(g), rtol=5e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_bag_forward_matches_jax_and_rejects_passing_v():
    feats, _, _, _ = _inputs(384, 300, True, seed=4)
    params, model = _models(seed=1)
    bag, mx = jpool.fused_bag_forward(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(feats), 300, tile_n=TILE,
                                      interpret=True)
    got_bag, got_max = ap.fused_bag_forward(model, torch.from_numpy(feats),
                                            n_valid=300)
    np.testing.assert_allclose(got_bag.numpy(), np.asarray(bag), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(mx), rtol=1e-5,
                               atol=1e-6)
    pv = DSMIL(DSMILConfig(feats_size=K, num_classes=C, passing_v=True), CPU)
    with pytest.raises(ValueError, match="passing_v"):
        ap.fused_bag_forward(pv, torch.from_numpy(feats))
    with pytest.raises(ValueError, match="passing_v"):
        jpool.fused_bag_forward({**params, "v": {"w": 0, "b": 0}},
                                jnp.asarray(feats), 300, tile_n=TILE,
                                interpret=True)


def test_wrappers_validate_inputs():
    feats, w, q_max, _ = _inputs(64, 64, True)
    f = torch.from_numpy(feats)
    ws = _torch_weights(w, True)
    qm = torch.from_numpy(q_max)
    with pytest.raises(ValueError, match="contiguous"):
        ap.attention_pool_fwd(f.T.contiguous().T, *ws, qm, 64)
    with pytest.raises(ValueError, match="n_valid"):
        ap.attention_pool_fwd(f, *ws, qm, 65)
    with pytest.raises(ValueError, match="classes"):
        ap.attention_pool_fwd(f, *ws, torch.zeros(9, D), 64)
    with pytest.raises(ValueError, match="float32"):
        ap.attention_pool_fwd(f.double(), *ws, qm, 64)
    with pytest.raises(ValueError, match="shape"):
        ap.attention_pool_fwd(f, ws[0][:, :32].contiguous(), *ws[1:], qm, 64)
    with pytest.raises(ValueError, match="w2 and b2"):
        ap.attention_pool_fwd(f, ws[0], ws[1], None, None, qm, 64, True)
    m, s, lg = torch.zeros(C), torch.ones(C), torch.zeros(64, C)
    db = torch.zeros(C, K)
    ap.attention_pool_bwd1(f, lg, m, s, db, 64)  # well-formed
    with pytest.raises(ValueError, match="shape"):
        ap.attention_pool_bwd1(f, lg, m, s, torch.zeros(C, K + 4), 64)
    with pytest.raises(ValueError, match="shape"):
        ap.attention_pool_bwd1(f, torch.zeros(63, C), m, s, db, 64)
    with pytest.raises(ValueError, match="shape"):
        ap.attention_pool_bwd1(f, torch.zeros(64, C + 1), m, s, db, 64)
    with pytest.raises(ValueError, match=r"\[N, C\]"):
        ap.attention_pool_bwd1(f, torch.zeros(64 * C), m, s, db, 64)
    with pytest.raises(ValueError, match="float32"):
        ap.attention_pool_bwd1(f, lg.double(), m, s, db, 64)
    with pytest.raises(ValueError, match="tensors on meta"):
        ap.attention_pool_bwd1(f, lg.to("meta"), m, s, db, 64)
    with pytest.raises(ValueError, match="n_valid"):
        ap.attention_pool_bwd1(f, lg, m, s, db, 0)
