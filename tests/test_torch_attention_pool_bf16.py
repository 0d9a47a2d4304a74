"""K1-bf16 of the port (tpumil_torch/ops/attention_pool.py:
attention_pool_bf16_plain, the wrapper attention_pool_fwd_bf16 and
fused_bag_forward(feats_dtype=torch.bfloat16)) against the JAX package's
fused_attention_pool(feats_dtype=jnp.bfloat16) in interpret mode, on the
same numpy inputs.

The bar: B, m and s within 1e-5 of max|JAX| (the same rounding points give
agreement at f32 level; rounding the softmax weights against the global max
instead of the running max moves B by ~1e-3 of its max), the bag logits at
rtol 1e-5. The two packages' f32 logits differ in their last bits (another
summation order), and where that flips the bf16 rounding of one weight p,
B moves by ~2^-8 p |f| / s: ~4e-7 of max|B| with the attention spread over
the bag (s ~ 10^3, the inputs below), but 2-4e-5 with q_max four times as
large (s ~ 10^2)."""

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

K, C, D = 160, 2, ap.ATTN_DIM
CPU = torch.device("cpu")
BF16 = torch.bfloat16


def _inputs(n, n_valid, nonlinear, k=K, seed=0):
    rng = np.random.default_rng(seed)
    feats = np.zeros((n, k), np.float32)
    feats[:n_valid] = rng.standard_normal((n_valid, k)) * 0.5
    w = {"w0": rng.standard_normal((D, k)) * 0.1,
         "b0": rng.standard_normal((D,)) * 0.1,
         "w2": rng.standard_normal((D, D)) * 0.1,
         "b2": rng.standard_normal((D,)) * 0.1}
    w = {name: v.astype(np.float32) for name, v in w.items()}
    q_max = (rng.standard_normal((C, D)) * 0.5).astype(np.float32)
    return feats, w, q_max


def _bf16_args(feats, w, q_max, nonlinear):
    t = {name: torch.from_numpy(v) for name, v in w.items()}
    return [torch.from_numpy(feats).to(BF16), t["w0"].to(BF16), t["b0"],
            t["w2"].to(BF16) if nonlinear else None,
            t["b2"] if nonlinear else None, torch.from_numpy(q_max).to(BF16)]


def _close(got, want, bar=1e-5):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= bar * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("nonlinear", [True, False])
@pytest.mark.parametrize("n,n_valid", [(1024, 1000), (2048, 1900)])
def test_plain_matches_pallas_bf16(nonlinear, n, n_valid):
    """The plain version at tile_n = 1024 (what the wrapper runs on the CPU)
    against the Pallas kernel's bf16 stream in interpret mode: B, m and s
    within 1e-5 of their max."""
    feats, w, q_max = _inputs(n, n_valid, nonlinear)
    qp = w if nonlinear else {"w": w["w0"], "b": w["b0"]}
    want_b, want_m, want_s = jpool.fused_attention_pool(
        jnp.asarray(feats), jax.tree.map(jnp.asarray, qp), jnp.asarray(q_max),
        n_valid, tile_n=1024, nonlinear=nonlinear, interpret=True,
        feats_dtype=jnp.bfloat16, return_stats=True)
    before = ap.attention_pool_fwd_bf16.launches
    b, m, s, logits = ap.attention_pool_fwd_bf16(
        *_bf16_args(feats, w, q_max, nonlinear), n_valid, nonlinear)
    assert ap.attention_pool_fwd_bf16.launches == before  # no kernel on CPU
    assert b.dtype == m.dtype == s.dtype == logits.dtype == torch.float32
    _close(b.numpy(), want_b)
    _close(m.numpy(), np.asarray(want_m)[0])
    _close(s.numpy(), np.asarray(want_s)[0])
    assert logits.shape == (n, C)
    assert (logits[n_valid:] == ap.NEG_INF).all()
    assert np.abs(b.numpy()).max() > 1e-2  # a real comparison


def test_plain_rounding_points():
    """tile_n=None (the card kernel's rounding, against the global max) is a
    single tile of every row, bitwise; per-1024-row tiles round the softmax
    weights elsewhere, and B moves."""
    feats, w, q_max = _inputs(2048, 1900, True, seed=1)
    args = _bf16_args(feats, w, q_max, True)
    whole = ap.attention_pool_bf16_plain(*args, 1900, True, tile_n=None)
    one_tile = ap.attention_pool_bf16_plain(*args, 1900, True, tile_n=2048)
    tiled = ap.attention_pool_bf16_plain(*args, 1900, True)
    for a, b in zip(whole, one_tile):
        assert torch.equal(a, b)
    assert torch.equal(whole[1], tiled[1]) and torch.equal(whole[3], tiled[3])
    gap = (whole[0] - tiled[0]).abs().max() / whole[0].abs().max()
    assert 0 < gap < 1e-2


def _models(seed=0, k=K, c=C, nonlinear=True):
    cfg = jdsmil.DSMILConfig(feats_size=k, num_classes=c, nonlinear=nonlinear)
    params = jax.tree.map(np.asarray,
                          jdsmil.init_params(jax.random.PRNGKey(seed), cfg))
    model = DSMIL(DSMILConfig(feats_size=k, num_classes=c,
                              nonlinear=nonlinear), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params))
    return params, model


@pytest.mark.parametrize("k", [K, 166])
def test_fused_bag_forward_bf16_matches_jax(k):
    """The eval forward with a bf16 feature stream, on carried-over params:
    bag logits at rtol 1e-5, the max instance logits (f32) too. K = 166 is
    zero-padded to 168 (16-byte rows of 8 bf16) before the pool and cut
    after it; JAX pools the unpadded K."""
    feats, _, _ = _inputs(2048, 1900, True, k=k, seed=4)
    params, model = _models(seed=1, k=k)
    bag, mx = jpool.fused_bag_forward(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(feats), 1900, interpret=True,
                                      feats_dtype=jnp.bfloat16)
    got_bag, got_max = ap.fused_bag_forward(model, torch.from_numpy(feats),
                                            n_valid=1900, feats_dtype=BF16)
    np.testing.assert_allclose(got_bag.numpy(), np.asarray(bag), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(mx), rtol=1e-5,
                               atol=1e-6)
    f32_bag, _ = ap.fused_bag_forward(model, torch.from_numpy(feats),
                                      n_valid=1900)
    assert not torch.equal(f32_bag, got_bag)  # the stream really was bf16


def test_aligned_pads_k_per_dtype():
    """K pads to a multiple of 4 in f32 and of 8 in bf16, in one copy that
    casts; an aligned f32 bag at K % 4 == 0 is used as it is."""
    f = torch.randn(5, 166)
    w0 = torch.randn(D, 166)
    pf, pw = ap._aligned(f, w0)
    assert pf.shape == (5, 168) and pf.dtype == torch.float32
    pb, pwb = ap._aligned(f, w0, BF16)
    assert pb.shape == (5, 168) and pb.dtype == pwb.dtype == BF16
    assert pwb.shape == (D, 168) and (pwb[:, 166:] == 0).all()
    assert torch.equal(pb[:, :166], f.to(BF16)) and (pb[:, 166:] == 0).all()
    pb, _ = ap._aligned(torch.randn(5, 164), torch.randn(D, 164), BF16)
    assert pb.shape == (5, 168)
    g = torch.randn(5, 160)
    assert ap._aligned(g, torch.randn(D, 160))[0] is g


def test_bf16_wrapper_and_forward_refuse_other_dtypes():
    feats, w, q_max = _inputs(64, 64, True)
    args = _bf16_args(feats, w, q_max, True)
    ap.attention_pool_fwd_bf16(*args, 64)  # well-formed
    with pytest.raises(ValueError, match="bfloat16"):
        ap.attention_pool_fwd_bf16(args[0].float(), *args[1:], 64)
    with pytest.raises(ValueError, match="bfloat16"):
        ap.attention_pool_fwd_bf16(args[0].half(), *args[1:], 64)
    with pytest.raises(ValueError, match="float32"):  # biases stay f32
        ap.attention_pool_fwd_bf16(*args[:2], args[2].to(BF16), *args[3:], 64)
    with pytest.raises(ValueError, match="float32"):  # K1 stays f32
        ap.attention_pool_fwd(*args, 64)
    _, model = _models(k=K)
    f = torch.from_numpy(feats)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="feats_dtype"):
            ap.fused_bag_forward(model, f, feats_dtype=bad)
