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
from hypothesis import given, settings
from hypothesis import strategies as st

from tpumil.models import dsmil as jdsmil
from tpumil.ops import dsmil_pallas as jpool
from tpumil_torch.io import from_jax
from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
from tpumil_torch.ops import attention_pool as ap
from tpumil_torch.ops.attention_pool import _aligned

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
    """The three rounding points of the softmax weights: one tile of every
    row (against the global max), per-1024-row tiles (the TPU kernel's, the
    CPU wrapper's) and per-64-row tiles in CTA ranges (the card kernel's).
    m and the logits are the same in all three; B moves."""
    feats, w, q_max = _inputs(2048, 1900, True, seed=1)
    args = _bf16_args(feats, w, q_max, True)
    whole = ap.attention_pool_bf16_plain(*args, 1900, True, tile_n=2048)
    card = ap.attention_pool_bf16_plain(
        *args, 1900, True, tile_n=ap.BF16_TILE,
        segment_rows=ap.bf16_partition(1900, 4))
    tiled = ap.attention_pool_bf16_plain(*args, 1900, True)
    for other in (whole, card):
        assert torch.equal(other[1], tiled[1])
        assert torch.equal(other[3], tiled[3])
        gap = (other[0] - tiled[0]).abs().max() / tiled[0].abs().max()
        assert 0 < gap < 1e-2


@settings(max_examples=300, deadline=None)
@given(n_valid=st.integers(1, 300000), sms=st.integers(1, 132))
def test_bf16_partition_covers_the_bag(n_valid, sms):
    """Rows per CTA: a multiple of the tile; the ranges [g rpc, (g + 1)
    rpc) are contiguous, none empty, cover [0, n_valid) in at most sms
    pieces, and one tile less per CTA would need more than sms."""
    rpc = ap.bf16_partition(n_valid, sms)
    assert rpc >= ap.BF16_TILE and rpc % ap.BF16_TILE == 0
    ctas = -(-n_valid // rpc)
    assert ctas <= sms and (ctas - 1) * rpc < n_valid <= ctas * rpc
    if rpc > ap.BF16_TILE:
        assert -(-n_valid // (rpc - ap.BF16_TILE)) > sms
    segs = ap._segments(n_valid + 7, n_valid, rpc)
    assert len(segs) == ctas and segs[0][0] == 0 and segs[-1][1] == n_valid + 7
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))


def _tile_path(args, n_valid, tile_n=1024):
    """The tile_n path as it was before segments: one online softmax over
    every row of the bag."""
    f = args[0].float()
    _, _, _, logits, _ = ap._recompute(
        f, args[1].float(), args[2], args[3].float(), args[4],
        args[5].float(), n_valid, True)
    c, k = logits.shape[1], f.shape[1]
    m = torch.full((c,), ap.NEG_INF)
    s = torch.zeros((c,))
    acc = torch.zeros((c, k))
    for r0 in range(0, f.shape[0], tile_n):
        a = logits[r0:r0 + tile_n]
        m_new = torch.maximum(m, a.amax(dim=0))
        corr = torch.exp(m - m_new)
        p = torch.exp(a - m_new)
        m = m_new
        s = s * corr + p.sum(dim=0)
        acc = acc * corr[:, None] + p.to(BF16).float().T @ f[r0:r0 + tile_n]
    return acc / s.clamp_min(1e-30)[:, None], m, s, logits


@pytest.mark.parametrize("tile_n", [1024, ap.BF16_TILE])
def test_one_segment_is_the_tile_path_bitwise(tile_n):
    """A segment that holds the whole bag is the tile_n path, bit for bit:
    its merge weight is exp(0) = 1."""
    feats, w, q_max = _inputs(2048, 1900, True, seed=2)
    args = _bf16_args(feats, w, q_max, True)
    want = _tile_path(args, 1900, tile_n)
    for rows in (None, 1900, 4096):
        got = ap.attention_pool_bf16_plain(*args, 1900, True, tile_n=tile_n,
                                           segment_rows=rows)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_segmented_plain_matches_float64():
    """The card's rounding points (64-row tiles, CTA ranges of 384 rows,
    the last one ragged) evaluated in f32 against the same arithmetic in
    float64 (the bf16 rounding of each weight included): B within 1e-6 of
    max|B| plus the rounding slack of the two logits; m, s and the logits
    within 1e-6 of their max."""
    n, n_valid, tile = 3000, 2900, ap.BF16_TILE
    feats, w, q_max = _inputs(n, n_valid, True, seed=3)
    args = _bf16_args(feats, w, q_max, True)
    rows = ap.bf16_partition(n_valid, 8)
    assert rows == 384 and n_valid % tile != 0
    got = ap.attention_pool_bf16_plain(*args, n_valid, True, tile_n=tile,
                                       segment_rows=rows)
    f = args[0].double()
    h = (f @ args[1].double().T + args[2].double()).relu()
    q = torch.tanh(h @ args[3].double().T + args[4].double())
    lg = q @ args[5].double().T / np.sqrt(D)
    lg[n_valid:] = ap.NEG_INF
    accs, ms, ss = [], [], []
    for r0, r1 in ap._segments(n, n_valid, rows):
        m = torch.full((C,), ap.NEG_INF, dtype=torch.float64)
        s = torch.zeros((C,), dtype=torch.float64)
        acc = torch.zeros((C, K), dtype=torch.float64)
        for t0 in range(r0, r1, tile):
            a = lg[t0:min(t0 + tile, r1)]
            m_new = torch.maximum(m, a.amax(dim=0))
            corr = torch.exp(m - m_new)
            p = torch.exp(a - m_new)
            m = m_new
            s = s * corr + p.sum(dim=0)
            acc = acc * corr[:, None] + p.to(BF16).double().T @ f[t0:t0 + len(a)]
        accs.append(acc)
        ms.append(m)
        ss.append(s)
    ms = torch.stack(ms)
    m = ms.amax(dim=0)
    wt = torch.exp(ms - m)
    s = (torch.stack(ss) * wt).sum(dim=0)
    b = (torch.stack(accs) * wt[:, :, None]).sum(dim=0) / s[:, None]
    slack = ap.bf16_rounding_slack(args[0], got[3], lg.float(), got[1],
                                   got[2], n_valid, tile, rows)
    err = (got[0].double() - b).abs().amax(dim=1)
    assert (err <= 1e-6 * b.abs().max() + slack.double()).all(), (err, slack)
    _close(got[1].numpy(), m.numpy(), 1e-6)
    _close(got[2].numpy(), s.numpy(), 1e-6)
    _close(got[3][:n_valid].numpy(), lg[:n_valid].numpy(), 1e-6)
    assert (got[3][n_valid:] == ap.NEG_INF).all()


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


def _aligned_before(feats, w0, dtype):
    """_aligned as it was: a zero-filled bag, then a copy into it."""
    k = feats.shape[1]
    per = 16 // torch.empty((), dtype=dtype).element_size()
    kp = -(-k // per) * per
    if kp == k and feats.data_ptr() % 16 == 0 and feats.dtype == dtype:
        return feats, w0.to(dtype)
    padded = feats.new_zeros((feats.shape[0], kp), dtype=dtype)
    padded[:, :k] = feats
    if kp != k:
        w0 = torch.nn.functional.pad(w0, (0, kp - k))
    return padded, w0.to(dtype)


@pytest.mark.parametrize("k", [512, 166])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_aligned_is_bitwise_as_before(k, dtype):
    """_aligned casts in one copy and zero-pads only the columns K needs:
    the same tensors, bit for bit, as the zero-fill-then-copy it replaced,
    for an aligned bag, a misaligned view and a padded K."""
    rng = np.random.default_rng(k)
    base = torch.from_numpy(rng.standard_normal(37 * k + 1)
                            .astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((D, k)).astype(np.float32))
    for f in (base[:-1].view(37, k), base[1:].view(37, k)):
        got, want = _aligned(f, w0, dtype), _aligned_before(f, w0, dtype)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.data_ptr() % 16 == 0
            assert torch.equal(a, b)
        assert (got[0] is f) == (want[0] is f)


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
